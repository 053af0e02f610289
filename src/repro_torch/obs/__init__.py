"""Observability for the port's serving path (copies of ``repro.obs``).

  * ``metrics`` — typed counters / gauges / histograms behind
    ``SecureGateway.metrics()`` and the Prometheus exposition;
  * ``trace``   — the process's tracer ``TRACER``: request, scheduler,
    engine, key-derivation and train-step spans on the profiler's clock,
    Chrome trace export;
  * ``audit``   — the HMAC-chained log of security events;
  * ``costs``   — per-(phase, tenant) sealed-byte ledger;
  * ``profiler``— device-synchronized phase timing on top of the ledger,
    synchronizing with ``torch.cuda.synchronize()``;
  * ``monitor`` + ``rules`` — the streaming SLO / posture monitor and its
    declarative rules, driving scheduler actions; ``dash`` renders the
    posture as a terminal snapshot.

All but ``profiler`` are framework-free copies of the reference modules.
"""
from .audit import (AuditError, AuditLog, derive_audit_key,  # noqa: F401
                    verify_jsonl, verify_records)
from .costs import (PHASES, CostLedger, cipher_blocks_for,  # noqa: F401
                    mac_ops_for)
from .dash import parse_prometheus, render, render_gateway  # noqa: F401
from .metrics import (Counter, Gauge, Histogram, MetricError,  # noqa: F401
                      MetricsRegistry, StatsView, escape_label_value)
from .monitor import Monitor, Sample  # noqa: F401
from .profiler import Profiler  # noqa: F401
from .rules import (Alert, ChainRule, HeadroomRule,  # noqa: F401
                    MonitorConfig, SloRule, StormRule, default_rules,
                    parse_slo_overrides)
from .trace import (TRACER, Tracer, chrome_trace,  # noqa: F401
                    jsonl_to_chrome, request_tid, TID_ENGINE)
