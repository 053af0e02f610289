"""The readers of the program's own spans (``benchlib/program_spans.py``)
against hand counts: device intervals, host launch calls and program
spans (nested and overlapping) built by hand, in µs scaled to ns."""
from pathlib import Path

import pytest

from benchlib import program_spans, readers
from benchlib.cell import Cell
from benchlib.profiling import Trace, traced

ROOT = Path(__file__).resolve().parents[2]
US = 1000                                      # ns a µs
SERVE = ("unseal_weights_ms.serve", "gather_unseal_ms.serve",
         "layers_ms.serve", "derive_launches.serve", "idle_in_derive.serve",
         "idle_off_engine.serve")
TRAIN = ("unseal_ms.train", "forward_ms.train", "backward_ms.train",
         "update_ms.train", "derive_launches.train", "idle_in_derive.train")


class FakeTracer:
    """The process tracer's read surface: finished spans as Chrome "X"
    events (µs), ``device_ms`` where the span was timed on a device."""

    def __init__(self, rows):
        self.rows = rows

    def spans(self):
        out = []
        for name, t0, t1, dms in self.rows:
            args = {"span_id": len(out) + 1}
            if dms is not None:
                args["device_ms"] = dms
            out.append({"name": name, "ph": "X", "ts": float(t0),
                        "dur": float(t1 - t0), "args": args})
        return out


@pytest.fixture
def program(monkeypatch):
    """Put a FakeTracer of the given rows where the readers look."""
    from repro_torch.obs import trace

    def put(rows):
        monkeypatch.setattr(trace, "TRACER", FakeTracer(rows))
    return put


def ns(*ivs):
    return [(n, a * US, b * US) for n, a, b in ivs]


def serve_trace(device=True) -> Trace:
    """Two steps in 10 ms.  Busy: 1000-2500, 4000-5000, 8000-9000 µs;
    idle between them: 2500-4000 and 5000-8000 (4500 µs)."""
    dev = ns(("k", 1000, 2000), ("k", 1500, 2500), ("k", 4000, 5000),
             ("k", 8000, 9000)) if device else []
    host = ns(("cudaLaunchKernel", 1100, 1150),     # outside a derivation
              ("cudaLaunchKernel", 3000, 3010),     # inside
              ("aten::bitwise_and", 3200, 3300),    # not a launch
              ("cuLaunchKernelEx", 3500, 3510),     # inside
              ("cudaStreamSynchronize", 3700, 3800),
              ("cudaMemcpyAsync", 6000, 6010),      # inside
              ("cudaMemsetAsync", 7000, 7010))      # outside
    return Trace(device=dev, host=host, spans=ns(("bench.step", 500, 9500)),
                 window_s=0.01, steps=2)


SERVE_SPANS = [
    # step 1: one engine call, its parts, derivations nested and overlapping
    ("engine.decode_step", 2600, 7000, None),
    ("engine.unseal_params", 2600, 4400, 1.5),
    ("seal.derive", 2800, 3600, None),
    ("seal.derive", 3000, 3200, None),
    ("seal.derive", 3400, 4200, None),
    ("engine.layers", 4400, 7000, 2.0),
    ("seal.derive", 5500, 6500, None),
    # step 2
    ("engine.decode_step", 7500, 7700, None),
    ("engine.unseal_params", 7500, 7600, 0.5),
    # after the traced stretch: not read
    ("engine.unseal_params", 20000, 20100, 9.0),
    ("seal.derive", 20000, 20100, None),
]


def test_serving_readers_by_hand(program):
    program(SERVE_SPANS)
    ctx = {"trace": serve_trace()}
    # device ms a step: (1.5 + 0.5) / 2 and 2.0 / 2; no gather timed
    assert program_spans.device_ms_per_step(
        ctx, "engine.unseal_params") == pytest.approx(1.0)
    assert program_spans.device_ms_per_step(
        ctx, "engine.layers") == pytest.approx(1.0)
    assert program_spans.device_ms_per_step(
        ctx, "engine.gather_unseal") is None
    # launches inside the derivations' union (2800-4200, 5500-6500):
    # 3000, 3500 and 6000, over 2 steps
    assert program_spans.derive_launches(ctx) == pytest.approx(1.5)
    # idle inside a derivation: 2800-4000 and 5500-6500, 2200 µs of 10 ms
    assert program_spans.idle_in_derive(ctx) == pytest.approx(22.0)
    # idle outside the engine calls (2600-7000, 7500-7700): 2500-2600,
    # 7000-7500 and 7700-8000, 900 µs of 10 ms
    assert program_spans.idle_off_engine(ctx) == pytest.approx(9.0)
    # both are shares of the idle time: 65% here
    assert readers.idle_share(ctx) == pytest.approx(65.0)
    assert 22.0 + 9.0 <= readers.idle_share(ctx)


def test_train_readers_by_hand(program):
    program([("train.unseal", 600, 1200, 0.4),
             ("seal.derive", 600, 700, None),
             ("train.forward", 1200, 3000, 1.25),
             ("train.backward", 3000, 5000, 2.5),
             ("train.forward", 5000, 6000, 1.0),
             ("train.backward", 6000, 7000, 2.0),
             ("train.update", 7000, 9400, 2.25),
             ("seal.derive", 8200, 8300, None),
             ("seal.derive", 8250, 8400, None)])
    tr = serve_trace()
    tr.steps = 1
    ctx = {"trace": tr}
    got = {m: program_spans.device_ms_per_step(ctx, f"train.{m}")
           for m in ("unseal", "forward", "backward", "update")}
    assert got == pytest.approx({"unseal": 0.4, "forward": 2.25,
                                 "backward": 4.5, "update": 2.25})
    # no launch starts in 600-700 or 8200-8400, where the device is busy
    # or not yet started
    assert program_spans.derive_launches(ctx) == 0
    assert program_spans.idle_in_derive(ctx) == 0
    # the parts sum to no more than the step's wall time
    assert sum(got.values()) <= tr.window_s * 1e3


def test_helpers_by_hand():
    assert program_spans.union([(5, 7), (1, 3), (2, 4), (4, 4)]) == \
        [(1, 4), (5, 7)]
    assert program_spans.overlap_ns([(0, 10), (20, 30)],
                                    [(5, 25), (28, 40)]) == 5 + 5 + 2
    assert program_spans.idle_gaps(serve_trace()) == [
        (2500 * US, 4000 * US), (5000 * US, 8000 * US)]


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_each_reader_gives_nothing_without_a_device(program, name):
    """On the CPU no device operation ran and no span was timed."""
    program([(n, t0, t1, None) for n, t0, t1, _ in SERVE_SPANS]
            + [("train.forward", 1200, 3000, None)])
    reader = Cell.load(ROOT, "granite-serve-code").reader(name)
    assert reader.read({"trace": serve_trace(device=False)}) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_each_reader_gives_nothing_for_a_program_without_the_tracer(
        monkeypatch, name):
    """An older program's trace module has no process tracer."""
    from repro_torch.obs import trace

    monkeypatch.delattr(trace, "TRACER")
    reader = Cell.load(ROOT, "granite-serve-code").reader(name)
    assert reader.read({"trace": serve_trace()}) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_each_reader_reads_its_metric_by_hand(program, name):
    program(SERVE_SPANS + [("train.unseal", 600, 1200, 0.4),
                           ("train.forward", 1200, 3000, 1.25),
                           ("train.backward", 3000, 5000, 2.5),
                           ("train.update", 7000, 9400, 2.25)])
    want = {"unseal_weights_ms.serve": 1.0, "gather_unseal_ms.serve": None,
            "layers_ms.serve": 1.0, "derive_launches.serve": 1.5,
            "idle_in_derive.serve": 22.0, "idle_off_engine.serve": 9.0,
            "unseal_ms.train": 0.2, "forward_ms.train": 0.625,
            "backward_ms.train": 1.25, "update_ms.train": 1.125,
            "derive_launches.train": 1.5, "idle_in_derive.train": 22.0}
    reader = Cell.load(ROOT, "granite-serve-code").reader(name)
    got = reader.read({"trace": serve_trace()})
    assert got == (None if want[name] is None else pytest.approx(want[name]))


def test_the_program_spans_land_in_the_traced_stretch():
    """The port's own tracer, under the harness's profiler on the CPU:
    its key derivations fall inside the stretch's clock, untimed."""
    import torch
    from repro_torch.core import cipher
    from repro_torch.obs.trace import TRACER

    TRACER.reset()
    holder: dict = {}
    key = torch.tensor([1, 2], dtype=torch.int32)
    cipher.derive_key(key, 7)                   # before: not recorded
    with traced(holder):
        cipher.derive_key(key, 7)
        cipher.derive_tensor_key(key, 9)
    cipher.derive_key(key, 7)                   # after: not recorded
    tr = holder["trace"]
    tr.steps = 1
    got = program_spans.program_spans(tr)
    assert [n for n, *_ in got] == ["seal.derive", "seal.derive"]
    # the profiler's host operators ran inside the two derivations
    (_, a0, a1, _), (_, b0, b1, _) = got
    assert a1 <= b0 and tr.host
    assert all(a0 - US <= t0 <= t1 <= a1 + US or b0 - US <= t0 <= t1 <= b1
               + US for _, t0, t1 in tr.host)
    assert all(d is None for *_, d in got)
    assert program_spans.device_ms_per_step({"trace": tr},
                                            "seal.derive") is None
    TRACER.reset()
