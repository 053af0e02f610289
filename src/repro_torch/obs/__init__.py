"""Observability for the port's serving path (copies of ``repro.obs`` parts).

  * ``metrics`` — typed counters / gauges / histograms (pool accounting);
  * ``trace``   — request and engine phase spans, Chrome trace export;
  * ``costs``   — per-(phase, tenant) sealed-byte ledger;
  * ``profiler``— device-synchronized phase timing on top of the ledger,
    synchronizing with ``torch.cuda.synchronize()``.
"""
from .costs import (PHASES, CostLedger, cipher_blocks_for,  # noqa: F401
                    mac_ops_for)
from .metrics import (Counter, Gauge, Histogram, MetricError,  # noqa: F401
                      MetricsRegistry, StatsView, escape_label_value)
from .profiler import Profiler  # noqa: F401
from .trace import (Tracer, chrome_trace, jsonl_to_chrome,  # noqa: F401
                    request_tid, TID_ENGINE, TID_REQ_BASE)
