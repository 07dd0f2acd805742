"""Continuous-batching serving (dense and paged), the lockstep server, the
prefix cache, the disaggregated deployment, expert-parallel decode and the
fleet (mirror of ``repro/serve``)."""

from repro_torch.serve.config import (ChaosCfg, DisaggCfg, EPCfg, FleetCfg,
                                      PagedCfg, PrefixCacheCfg, ServeConfig,
                                      ServeConfigError, build_deployment)
from repro_torch.serve.engine import (BatchedServer,
                                      ContinuousBatchingEngine,
                                      ContinuousProgram, ServeProgram,
                                      make_continuous_program,
                                      make_serve_program)
from repro_torch.serve.ep_decode import (EPContinuousBatchingEngine,
                                         EPDecodeConfig)
from repro_torch.serve.kv_blocks import BlockAllocator, pages_for
from repro_torch.serve.kv_transfer import KVTransferEngine, TransferStats
from repro_torch.serve.metrics import RoutingEMA, ServeMetrics
from repro_torch.serve.prefix_index import PrefixIndex
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.serve.scheduler import (DecodeScheduler, PrefillScheduler,
                                         Request, Scheduler)

__all__ = ["BatchedServer", "ServeProgram", "make_serve_program",
           "ContinuousBatchingEngine", "ContinuousProgram",
           "make_continuous_program", "ServeMetrics", "SamplingParams",
           "GREEDY", "Request", "Scheduler", "PrefillScheduler",
           "DecodeScheduler", "BlockAllocator", "pages_for",
           "KVTransferEngine", "TransferStats", "EPDecodeConfig",
           "EPContinuousBatchingEngine", "RoutingEMA", "PrefixIndex",
           "ServeConfig", "ServeConfigError", "build_deployment",
           "PagedCfg", "PrefixCacheCfg", "DisaggCfg", "EPCfg", "FleetCfg",
           "ChaosCfg"]
