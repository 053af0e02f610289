#!/usr/bin/env python
"""Convert a JSONL trace export into the Chrome trace_event JSON object.

The gateway's ``export_trace(path, fmt="jsonl")`` writes one trace event per
line — the streaming/greppable form.  Perfetto (https://ui.perfetto.dev) and
chrome://tracing load the object form ``{"traceEvents": [...]}``; this tool
is the bridge:

    python tools/trace2perfetto_torch.py trace.jsonl trace.json
    python tools/trace2perfetto_torch.py trace.jsonl          # -> trace.jsonl.json

The conversion logic lives in ``repro_torch.obs.trace.jsonl_to_chrome`` (unit
tested); this file is argument handling only.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.obs import jsonl_to_chrome  # noqa: E402


def main(argv: list[str]) -> int:
    if not 1 <= len(argv) <= 2:
        print(__doc__.strip())
        return 2
    src = argv[0]
    dst = argv[1] if len(argv) == 2 else src + ".json"
    with open(src) as f:
        obj = jsonl_to_chrome(f)
    with open(dst, "w") as f:
        json.dump(obj, f)
    print(f"{dst}: {len(obj['traceEvents'])} events "
          "(load at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
