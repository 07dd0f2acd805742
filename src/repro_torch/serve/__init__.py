"""Paged continuous-batching serving, the prefix cache and the
disaggregated deployment (mirror of ``repro/serve``)."""

from repro_torch.serve.config import (DisaggCfg, PagedCfg, PrefixCacheCfg,
                                      ServeConfig, ServeConfigError,
                                      build_deployment)
from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                      ContinuousProgram,
                                      make_continuous_program)
from repro_torch.serve.kv_blocks import BlockAllocator, pages_for
from repro_torch.serve.kv_transfer import KVTransferEngine, TransferStats
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.prefix_index import PrefixIndex
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.serve.scheduler import (DecodeScheduler, PrefillScheduler,
                                         Request, Scheduler)

__all__ = ["ContinuousBatchingEngine", "ContinuousProgram",
           "make_continuous_program", "ServeMetrics", "SamplingParams",
           "GREEDY", "Request", "Scheduler", "PrefillScheduler",
           "DecodeScheduler", "BlockAllocator", "pages_for",
           "KVTransferEngine", "TransferStats", "PrefixIndex", "ServeConfig",
           "ServeConfigError", "build_deployment", "PagedCfg",
           "PrefixCacheCfg", "DisaggCfg"]
