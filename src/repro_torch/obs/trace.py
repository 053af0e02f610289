"""Tracer — low-overhead in-process request/engine tracing.

Records the serving stack's activity as *trace events* in the Chrome
``trace_event`` vocabulary (the format Perfetto and chrome://tracing load
natively): complete spans (``ph: "X"`` with a start timestamp and duration)
and instant events (``ph: "i"``), laid out on virtual threads:

    tid 0                the engine lane: per-step phase spans
                         (serve_step > admit / prefill_chunk / decode,
                         plus page_close / page_reopen / swap copies)
    tid 100 + rid        one lane per request: its lifecycle as spans
                         (queued -> prefill [-> swapped -> ...] -> decode)
                         with instants at submit / swap_out / finish / poison

Design constraints:

  * cheap when on — an event is one dict append, timestamps come from
    ``time.monotonic`` once per call, nothing is serialized until export;
  * free when off — ``Tracer(enabled=False)`` short-circuits every emit;
  * two export formats — newline-delimited JSON (one event per line, the
    streaming/greppable form) and the Chrome JSON object
    ``{"traceEvents": [...]}`` that opens directly in Perfetto
    (https://ui.perfetto.dev -> Open trace file).  The JSONL form converts
    to the latter with ``tools/trace2perfetto.py``.

Timestamps are microseconds relative to the tracer's construction (Chrome
traces need only a consistent monotonic µs clock, not wall time).
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager

# virtual-thread layout (see module docstring)
TID_ENGINE = 0
TID_REQ_BASE = 100          # request rid r traces on tid TID_REQ_BASE + r
DEFAULT_PID = 1


def request_tid(rid: int) -> int:
    return TID_REQ_BASE + int(rid)


class Tracer:
    """In-process trace-event recorder (Chrome trace_event vocabulary)."""

    def __init__(self, enabled: bool = True, pid: int = DEFAULT_PID):
        self.enabled = enabled
        self.pid = pid
        self.events: list[dict] = []
        self._t0 = time.monotonic()
        self._open: dict[object, tuple] = {}    # key -> (name, cat, ts, tid, args)
        self._thread_names: dict[int, str] = {}
        self._process_name: str | None = None

    # -- clock -----------------------------------------------------------
    def now_us(self) -> float:
        return (time.monotonic() - self._t0) * 1e6

    # -- naming (Perfetto track labels) ----------------------------------
    def name_process(self, name: str) -> None:
        self._process_name = name

    def name_thread(self, tid: int, name: str) -> None:
        if self.enabled:
            self._thread_names[tid] = name

    # -- emit ------------------------------------------------------------
    def complete(self, name: str, t0_us: float, t1_us: float, *,
                 cat: str = "serve", tid: int = TID_ENGINE,
                 args: dict | None = None) -> None:
        """One finished span [t0_us, t1_us] (ph "X")."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X", "pid": self.pid,
              "tid": tid, "ts": t0_us, "dur": max(0.0, t1_us - t0_us)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, *, cat: str = "serve",
                tid: int = TID_ENGINE, args: dict | None = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "pid": self.pid, "tid": tid, "ts": self.now_us()}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: dict, *, cat: str = "counter",
                tid: int = TID_ENGINE, ts_us: float | None = None) -> None:
        """One counter-track sample (ph "C").

        Perfetto renders each (name, args key) series as a counter track
        under the process; ``values`` maps series name -> numeric sample
        (e.g. ``counter("dispatches", {"per_step": 2})`` per gateway step).
        """
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "C", "pid": self.pid,
            "tid": tid, "ts": self.now_us() if ts_us is None else ts_us,
            "args": {k: float(v) for k, v in values.items()}})

    def begin(self, key, name: str, *, cat: str = "serve",
              tid: int = TID_ENGINE, ts_us: float | None = None,
              args: dict | None = None) -> None:
        """Open a span under ``key``; ``end(key)`` closes it.

        Used for spans whose lifetime crosses scheduler steps (a request's
        "queued" / "prefill" / "decode" / "swapped" phases).  Re-opening a
        live key closes the old span first (defensive — transitions should
        pair up, but a dropped end must not wedge the tracer).
        """
        if not self.enabled:
            return
        if key in self._open:
            self.end(key)
        self._open[key] = (name, cat,
                           self.now_us() if ts_us is None else ts_us,
                           tid, dict(args) if args else {})

    def end(self, key, ts_us: float | None = None,
            args: dict | None = None) -> None:
        """Close the span opened under ``key`` (no-op for unknown keys)."""
        if not self.enabled:
            return
        opened = self._open.pop(key, None)
        if opened is None:
            return
        name, cat, t0, tid, a = opened
        if args:
            a.update(args)
        self.complete(name, t0, self.now_us() if ts_us is None else ts_us,
                      cat=cat, tid=tid, args=a or None)

    @contextmanager
    def span(self, name: str, *, cat: str = "serve", tid: int = TID_ENGINE,
             args: dict | None = None):
        """Context-managed complete span around a code block."""
        if not self.enabled:
            yield
            return
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, t0, self.now_us(), cat=cat, tid=tid,
                          args=args)

    # -- export ----------------------------------------------------------
    def _metadata_events(self) -> list[dict]:
        meta = []
        if self._process_name is not None:
            meta.append({"name": "process_name", "ph": "M", "pid": self.pid,
                         "tid": 0, "args": {"name": self._process_name}})
        for tid, name in sorted(self._thread_names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                         "tid": tid, "args": {"name": name}})
        return meta

    def drain(self) -> list[dict]:
        """All events so far (metadata first), leaving the buffer intact."""
        return self._metadata_events() + list(self.events)

    def to_jsonl(self, path: str) -> int:
        """One trace event per line.  Returns the event count written."""
        events = self.drain()
        with open(path, "w") as f:
            for ev in events:
                f.write(json.dumps(ev, sort_keys=True) + "\n")
        return len(events)

    def to_chrome_trace(self, path: str) -> int:
        """Chrome JSON object format — opens directly in Perfetto."""
        events = self.drain()
        with open(path, "w") as f:
            json.dump(chrome_trace(events), f)
        return len(events)

    def reset(self) -> None:
        self.events.clear()
        self._open.clear()


def chrome_trace(events: list[dict]) -> dict:
    """Wrap a flat event list in the Chrome JSON object format."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


def jsonl_to_chrome(lines) -> dict:
    """Parse JSONL trace lines (strings or dicts) -> Chrome JSON object.

    The conversion tools/trace2perfetto.py performs; kept here so the CLI
    is a thin wrapper and the logic is unit-testable.
    """
    events = []
    for line in lines:
        if isinstance(line, (bytes, str)):
            line = line.strip()
            if not line:
                continue
            line = json.loads(line)
        events.append(line)
    return chrome_trace(events)
