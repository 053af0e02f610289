"""Tracer — the port's in-process spans, on the device trace's clock.

One ``Tracer`` a process, ``TRACER``: the gateway, the engine, the
scheduler, the trainer and the key derivation of ``core/cipher.py`` and
``core/mac.py`` all emit into it.  It records the program's activity as
*trace events* in the Chrome ``trace_event`` vocabulary (the format
Perfetto and chrome://tracing load natively): complete spans (``ph: "X"``
with a start timestamp and duration), instant events (``ph: "i"``) and
counter samples (``ph: "C"``), laid out on virtual threads:

    tid 0                the engine lane: per-step phase spans
                         (serve_step > sched.* > engine.* > seal.derive,
                         the train step's train.* spans)
    tid base + rid       one lane per request: its lifecycle as spans
                         (queued -> prefill [-> swapped -> ...] -> decode)
                         with instants at submit / swap_out / finish / poison;
                         each scheduler takes its own ``lane_base()`` (100 for
                         the first since ``start()``, then 100 + 100000, ...)
                         and keys its open spans by itself, so two gateways
                         recording at once keep their requests apart

When it records:

  * while switched on: ``start(owner)`` (``SecureGateway(trace=True)``)
    until ``stop(owner)`` (the gateway's ``close()``, or its collection).
    A later ``start`` takes the tracer over, and a stop by an owner that
    no longer holds it does nothing;
  * while a torch profiler records in the process
    (``torch._C._autograd._profiler_enabled()``), so that a profiled
    stretch carries the program's spans beside the device's kernels;
  * otherwise a span costs one check and returns a shared no-op context:
    no dict, no generator, no CUDA event.

Its clock is ``time.time_ns()``, the Unix-epoch clock that torch.profiler
stamps its host events with, so a span's interval can be laid over the
profiler's host and device events.  Chrome exports give microseconds.

Each span records its id and its parent's (``args.span_id`` /
``args.parent_id``): the innermost span open on the same thread when it
began, so a layer's self time is its duration less its children's.  A
span opened with ``device=<torch.device>`` on a CUDA device also records a
``torch.cuda.Event`` on the current stream at entry and exit; its
``args.device_ms`` (the stream's time from the span's first operation to
its last, idle inside included) is read from the two events once the work
has completed.  The tracer never synchronises.

This module imports nothing from ``core/`` (which emits into it).
"""
from __future__ import annotations

import itertools
import json
import threading
import time

import torch

try:
    from torch._C._autograd import _profiler_enabled
except ImportError:           # a torch build without the autograd profiler
    def _profiler_enabled() -> bool:
        return False

# virtual-thread layout (see module docstring)
TID_ENGINE = 0
TID_REQ_BASE = 100          # the first scheduler's request rid r: tid 100 + r
LANE_STRIDE = 100_000       # request lanes a scheduler before the next's
DEFAULT_PID = 1
# device spans whose events are read once this many wait
_RESOLVE_EVERY = 256


def request_tid(rid: int, base: int = TID_REQ_BASE) -> int:
    return base + int(rid)


def now_us() -> float:
    """The tracer's clock in µs (Unix epoch, the profiler's host clock)."""
    return time.time_ns() / 1e3


class _NullSpan:
    """The context a span returns while the tracer does not record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One context-managed span while the tracer records."""

    __slots__ = ("tracer", "name", "cat", "tid", "args", "cuda", "t0",
                 "ev0", "id", "parent")

    def __init__(self, tracer, name, cat, tid, args, cuda):
        self.tracer, self.name, self.cat, self.tid = tracer, name, cat, tid
        self.args, self.cuda, self.ev0 = args, cuda, None

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(tr._ids)
        stack.append(self.id)
        self.t0 = time.time_ns()
        if self.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        return self

    def __exit__(self, *exc) -> bool:
        ev1 = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        t1 = time.time_ns()
        tr = self.tracer
        tr._stack().pop()
        ev = tr._complete(self.name, self.t0, t1, self.cat, self.tid,
                          self.args, self.id, self.parent)
        if ev1 is not None:
            tr._pending.append((ev, self.ev0, ev1))
            if len(tr._pending) >= _RESOLVE_EVERY:
                tr._resolve()
        return False


class Tracer:
    """In-process trace-event recorder (Chrome trace_event vocabulary)."""

    def __init__(self, enabled: bool = False, pid: int = DEFAULT_PID):
        self.enabled = enabled
        self.pid = pid
        self.events: list[dict] = []
        # key -> (name, cat, t0 ns, tid, args, span id, parent id)
        self._open: dict[object, tuple] = {}
        self._thread_names: dict[int, str] = {}
        self._process_name: str | None = None
        self._pending: list[tuple] = []        # (event, cuda start, cuda end)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._owner = None                     # who switched it on
        self._lanes = itertools.count()

    # -- switch ----------------------------------------------------------
    @property
    def recording(self) -> bool:
        """Switched on, or a torch profiler records in this process."""
        return self.enabled or _profiler_enabled()

    def start(self, owner=None) -> None:
        """Switch on with an empty buffer, held by ``owner`` (taken over
        from any earlier holder); request lanes count afresh from 100."""
        self.reset()
        self._lanes = itertools.count()
        self._owner = owner
        self.enabled = True

    def stop(self, owner=None) -> None:
        """Switch off, if ``owner`` holds the tracer; the buffer stays for
        export.  A profiler that records still makes it record."""
        if owner is self._owner:
            self.enabled = False
            self._owner = None

    def lane_base(self) -> int:
        """The first request lane of a new scheduler (tid base + rid)."""
        return TID_REQ_BASE + next(self._lanes) * LANE_STRIDE

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- naming (Perfetto track labels) ----------------------------------
    def name_process(self, name: str) -> None:
        self._process_name = name

    def name_thread(self, tid: int, name: str) -> None:
        if self.recording:
            self._thread_names[tid] = name

    # -- emit ------------------------------------------------------------
    def _complete(self, name, t0_ns, t1_ns, cat, tid, args, span_id,
                  parent) -> dict:
        a = dict(args) if args else {}
        a["span_id"] = span_id
        if parent is not None:
            a["parent_id"] = parent
        ev = {"name": name, "cat": cat, "ph": "X", "pid": self.pid,
              "tid": tid, "ts": t0_ns / 1e3,
              "dur": max(0, t1_ns - t0_ns) / 1e3, "args": a}
        self.events.append(ev)
        return ev

    def span(self, name: str, *, cat: str = "serve", tid: int = TID_ENGINE,
             args: dict | None = None, device=None):
        """Context-managed complete span around a code block.  ``device``:
        the torch.device the block's work runs on; a CUDA one times the
        block on the current stream too (``args.device_ms``)."""
        if not (self.enabled or _profiler_enabled()):   # ``recording``
            return _NULL_SPAN
        return _Span(self, name, cat, tid, args,
                     getattr(device, "type", None) == "cuda")

    def instant(self, name: str, *, cat: str = "serve",
                tid: int = TID_ENGINE, args: dict | None = None) -> None:
        if not self.recording:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "pid": self.pid, "tid": tid, "ts": now_us()}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: dict, *, cat: str = "counter",
                tid: int = TID_ENGINE) -> None:
        """One counter-track sample (ph "C").

        Perfetto renders each (name, args key) series as a counter track
        under the process; ``values`` maps series name -> numeric sample
        (e.g. ``counter("dispatches", {"per_step": 2})`` per gateway step).
        """
        if not self.recording:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "C", "pid": self.pid,
            "tid": tid, "ts": now_us(),
            "args": {k: float(v) for k, v in values.items()}})

    def begin(self, key, name: str, *, cat: str = "serve",
              tid: int = TID_ENGINE, args: dict | None = None) -> None:
        """Open a span under ``key``; ``end(key)`` closes it.

        Used for spans whose lifetime crosses scheduler steps (a request's
        "queued" / "prefill" / "decode" / "swapped" phases).  Re-opening a
        live key closes the old span first (defensive — transitions should
        pair up, but a dropped end must not wedge the tracer).
        """
        if not self.recording:
            return
        if key in self._open:
            self.end(key)
        stack = self._stack()
        self._open[key] = (name, cat, time.time_ns(), tid,
                           dict(args) if args else {}, next(self._ids),
                           stack[-1] if stack else None)

    def end(self, key, args: dict | None = None) -> None:
        """Close the span opened under ``key`` (no-op for unknown keys)."""
        opened = self._open.pop(key, None)
        if opened is None:
            return
        name, cat, t0, tid, a, span_id, parent = opened
        if args:
            a.update(args)
        self._complete(name, t0, time.time_ns(), cat, tid, a, span_id,
                       parent)

    # -- read ------------------------------------------------------------
    def _resolve(self) -> None:
        """Put ``device_ms`` into the device spans whose work completed."""
        left = []
        for ev, e0, e1 in self._pending:
            if e1.query():
                ev["args"]["device_ms"] = e0.elapsed_time(e1)
            else:
                left.append((ev, e0, e1))
        self._pending = left

    def spans(self) -> list[dict]:
        """The finished spans ("X" events), device times read where their
        work has completed."""
        self._resolve()
        return [ev for ev in self.events if ev["ph"] == "X"]

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
        self._resolve()
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
        self._pending.clear()
        self._thread_names.clear()


# the process's tracer: every layer of the port emits into this one
TRACER = Tracer()


def chrome_trace(events: list[dict]) -> dict:
    """Wrap a flat event list in the Chrome JSON object format."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


def jsonl_to_chrome(lines) -> dict:
    """Parse JSONL trace lines (strings or dicts) -> Chrome JSON object.

    The conversion tools/trace2perfetto_torch.py performs; kept here so
    the CLI is a thin wrapper and the logic is unit-testable.
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
