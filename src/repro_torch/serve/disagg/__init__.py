"""Disaggregated prefill/decode serving (mirror of ``repro/serve/disagg``,
DESIGN.md §10)."""

from repro_torch.serve.disagg.controller import DisaggController, make_disagg
from repro_torch.serve.disagg.workers import (DecodeWorker, MigrationTicket,
                                              PrefillWorker)

__all__ = ["DisaggController", "make_disagg", "PrefillWorker",
           "DecodeWorker", "MigrationTicket"]
