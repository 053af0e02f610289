#!/usr/bin/env python
"""Terminal posture snapshot from exported gateway observability files.

Renders the same dashboard ``repro_torch.launch.serve --watch`` prints live —
SLO readouts, per-tenant security posture, recent alerts and the audit
tail — but offline, from a saved Prometheus exposition
(``gateway.metrics_text()``) plus an exported audit log:

    python tools/obs_dash_torch.py BENCH_metrics.prom BENCH_audit.jsonl
    python tools/obs_dash_torch.py metrics.prom audit.jsonl \\
        --slo ttft_p95_ms=250 --tail 12

Posture and alerts are reconstructed from the audit records alone, so the
snapshot an offline reader sees matches what the live Monitor derived —
that is the point of routing posture through the chained log.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.obs import dash  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="offline posture dashboard (see module docstring)")
    ap.add_argument("metrics", help="Prometheus exposition text file")
    ap.add_argument("audit", nargs="?",
                    help="audit JSONL export (optional; posture and the "
                         "audit tail are empty without it)")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="NAME=BOUND",
                    help="mark an SLO bound on the readout (repeatable), "
                         "e.g. ttft_p95_ms=250")
    ap.add_argument("--tail", type=int, default=8,
                    help="alert / audit rows to show (default 8)")
    args = ap.parse_args(argv)
    try:
        with open(args.metrics) as f:
            families = dash.parse_prometheus(f.read())
        records = dash.load_audit_jsonl(args.audit) if args.audit else []
        bounds = {}
        for pair in args.slo:
            name, sep, raw = pair.partition("=")
            if not sep:
                raise ValueError(f"bad --slo {pair!r} (want name=bound)")
            bounds[name.strip()] = float(raw)
    except (OSError, ValueError) as e:
        print(f"obs_dash: ERROR — {e}", file=sys.stderr)
        return 2
    print(dash.render(families, records, slo_bounds=bounds,
                      tail=args.tail))
    return 0


if __name__ == "__main__":
    sys.exit(main())
