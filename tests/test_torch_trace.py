"""The port's process tracer (``repro_torch.obs.trace``) on the CPU: its
clock is torch.profiler's, it records only when switched on or while a
profiler records, parents nest, and the sealed gateway and train step
emit the spans the benchmark reads (key derivation, weight and KV
unseal, the layer loop, the train step's parts).  Also the gateway's
measurement window, which starts at its first step."""
import gc
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.obs.trace import TRACER, Tracer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serve import SecureGateway  # noqa: E402
from repro_torch.train import make_train_step, seal_state  # noqa: E402

torch.set_num_threads(1)

KEY = torch.tensor([0x5EC0DE, 0xFACADE], dtype=torch.int32)
ENGINE_CALLS = ("engine.chunk_prefill", "engine.decode_step")
ENGINE_PARTS = ("engine.unseal_params", "engine.gather_unseal",
                "engine.layers")


@pytest.fixture
def process_tracer():
    """The process tracer, off and empty before and after the test."""
    TRACER.start()              # empty, held by no one, lanes from 100
    TRACER.stop()
    yield TRACER
    TRACER.start()
    TRACER.stop()


def names(spans) -> list:
    return [s["name"] for s in spans]


def by_id(spans) -> dict:
    return {s["args"]["span_id"]: s for s in spans}


def test_a_span_contains_a_record_function_inside_it():
    """Shared clock: the profiler stamps the range inside the span."""
    tr = Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with record_function("inner_range"):
                torch.ones(64).sum()
    (s,) = tr.spans()
    t0, t1 = s["ts"] * 1e3, (s["ts"] + s["dur"]) * 1e3
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner_range"]
    # the span's µs timestamps round to a quarter µs at the epoch's size
    assert t0 - 1e3 <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= t1 + 1e3


def test_off_by_default_records_nothing_and_makes_no_cuda_event(
        monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1))
    tr = Tracer()
    assert not tr.enabled and not tr.recording
    span = tr.span("engine.layers", device=torch.device("cuda"))
    assert span is trace._NULL_SPAN          # no object made for the span
    with span:
        pass
    tr.instant("submit")
    tr.counter("dispatches", {"per_step": 1})
    tr.begin(("req", 1), "queued")
    tr.end(("req", 1))
    tr.name_thread(100, "req 1")
    assert tr.events == [] and tr.drain() == [] and made == []


def test_records_under_a_profiler_and_stops_with_it():
    tr = Tracer()
    with tr.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert tr.recording
        with tr.span("during", device=torch.device("cpu")):
            tr.instant("mark")
    assert not tr.recording
    with tr.span("after"):
        pass
    assert [e["name"] for e in tr.events] == ["mark", "during"]
    (s,) = tr.spans()
    assert "device_ms" not in s["args"]       # no device on the CPU


def test_parents_are_the_innermost_open_span():
    tr = Tracer(enabled=True)
    with tr.span("a"):
        with tr.span("b"):
            with tr.span("c"):
                pass
            tr.begin("k", "lifecycle")
        with tr.span("d"):
            tr.end("k")
    spans = {s["name"]: s for s in tr.spans()}
    ids = {n: s["args"]["span_id"] for n, s in spans.items()}
    assert len(set(ids.values())) == 5
    assert "parent_id" not in spans["a"]["args"]
    assert spans["b"]["args"]["parent_id"] == ids["a"]
    assert spans["c"]["args"]["parent_id"] == ids["b"]
    assert spans["d"]["args"]["parent_id"] == ids["a"]
    # a span that crosses steps takes the span open when it began
    assert spans["lifecycle"]["args"]["parent_id"] == ids["b"]
    a, b, c = spans["a"], spans["b"], spans["c"]
    assert a["ts"] <= b["ts"] <= c["ts"]
    assert c["ts"] + c["dur"] <= b["ts"] + b["dur"] <= a["ts"] + a["dur"]


def test_gateway_trace_switches_the_process_tracer_on(process_tracer):
    TRACER.instant("stale")
    gw = small_gateway(trace=True)
    # on, the buffer emptied: what it holds is this gateway's set-up
    assert TRACER.enabled
    assert "stale" not in [e["name"] for e in TRACER.events]
    gw.submit("alice", np.arange(5), max_new=2)
    gw.step()
    assert "serve_step" in names(TRACER.spans())


def test_start_and_stop_belong_to_the_holder():
    tr = Tracer()
    a, b = object(), object()
    tr.start(a)
    assert tr.enabled and tr.lane_base() == 100
    assert tr.lane_base() == 100 + trace.LANE_STRIDE
    tr.instant("mark")
    tr.start(b)                      # b takes it over, the buffer emptied
    assert tr.events == [] and tr.lane_base() == 100
    tr.stop(a)                       # a no longer holds it
    assert tr.enabled
    tr.instant("kept")
    tr.stop(b)
    assert not tr.enabled and not tr.recording
    tr.instant("dropped")
    assert [e["name"] for e in tr.events] == ["kept"]   # kept for export


def test_closing_a_traced_gateway_switches_the_tracer_off(process_tracer):
    gw = small_gateway(trace=True)
    gw.submit("alice", np.arange(5), max_new=2)
    gw.step()
    gw.close()
    assert not TRACER.enabled and not TRACER.recording
    n = len(TRACER.events)
    assert n > 0                     # the buffer stays for export
    gw.step()
    assert len(TRACER.events) == n
    gw.close()                       # twice is fine
    # an untraced gateway's close leaves a traced one's tracer on; a
    # later traced gateway takes it over from an earlier one
    first = small_gateway(trace=True)
    small_gateway().close()
    assert TRACER.enabled
    second = small_gateway(trace=True)
    first.close()
    assert TRACER.enabled
    second.close()
    assert not TRACER.enabled
    # collection switches it off too
    small_gateway(trace=True)
    gc.collect()
    assert not TRACER.enabled


def test_two_recording_gateways_keep_their_requests_apart(process_tracer):
    gws = [small_gateway() for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU]):
        for gw in gws:               # both number their request 1
            gw.submit("alice", np.arange(5), max_new=2)
        for _ in range(3):
            for gw in gws:
                gw.step()
    lanes = {}
    for s in TRACER.spans():
        if s["cat"] == "request":
            lanes.setdefault(s["tid"], []).append(s)
    assert sorted(lanes) == [101, 101 + trace.LANE_STRIDE]
    for spans in lanes.values():
        # each lane: its own request's queued -> prefill [-> decode], none
        # cut short by the other gateway's request 1
        got = names(sorted(spans, key=lambda s: s["ts"]))
        assert got[:2] == ["queued", "prefill"]
        assert got.count("queued") == 1


def small_gateway(**kw):
    cfg = configs.get_config("granite-3-2b", smoke=True)
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(0),
                                          cfg, "cpu")
    return SecureGateway(cfg, params, security="trusted", device="cpu",
                         max_slots=2, page_size=8, n_pages=16,
                         max_pages_per_seq=3, **kw)


def test_sealed_gateway_steps_under_the_profiler(process_tracer):
    gw = small_gateway()
    rng = np.random.RandomState(5)
    for i, n in enumerate((9, 13)):
        gw.submit(f"tenant-{i}", rng.randint(0, 512, n), max_new=3)
    gw.step()                                  # outside: nothing recorded
    assert TRACER.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        gw.step()
        gw.step()
    spans = TRACER.spans()
    got = names(spans)
    assert got.count("serve_step") == 2
    assert "seal.derive" in got
    calls = [s for s in spans if s["name"] in ENGINE_CALLS]
    assert calls
    ids = by_id(spans)
    for part in ENGINE_PARTS:
        mine = [s for s in spans if s["name"] == part]
        # once per engine call, inside it
        assert len(mine) == len(calls)
        assert all(ids[s["args"]["parent_id"]]["name"] in ENGINE_CALLS
                   for s in mine)
    # key derivation nests under the unseals
    parents = {ids[s["args"]["parent_id"]]["name"] for s in spans
               if s["name"] == "seal.derive" and "parent_id" in s["args"]}
    assert {"engine.unseal_params", "engine.gather_unseal"} <= parents


def test_sealed_train_step_of_two_microbatches(process_tracer):
    cfg = configs.get_config("granite-3-2b", smoke=True)
    params = transformer.init(torch.Generator().manual_seed(0), cfg, "cpu")
    sec = policy.SecurityConfig()
    opt = AdamW(lr=1e-3)
    state = seal_state(opt.init(params), KEY, sec)
    step = make_train_step(transformer, cfg, opt, sec, KEY)
    mb = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=2).microbatches_at(
        0, 2)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in mb.items()}
    with profile(activities=[ProfilerActivity.CPU]):
        state, m = step(state, batch)
    assert bool(m["seal_ok"])
    got = names(TRACER.spans())
    assert [got.count(n) for n in ("train.unseal", "train.forward",
                                   "train.backward", "train.update")] \
        == [1, 2, 2, 1]
    assert got.count("seal.derive") > 0
    train = [s for s in TRACER.spans() if s["name"].startswith("train.")]
    assert all("parent_id" not in s["args"] for s in train)


def test_gateway_window_starts_at_the_first_step():
    gw = small_gateway()
    m = gw.metrics()
    assert m["elapsed_s"] == 0.0 and m["tok_per_s"] == 0.0
    time.sleep(0.5)                            # idle set-up, not counted
    gw.submit("alice", np.arange(6), max_new=2)
    t0 = time.monotonic()
    gw.step()
    gw.step()
    took = time.monotonic() - t0
    m = gw.metrics()
    assert 0.0 < m["elapsed_s"] <= took + 0.05
    assert m["tok_per_s"] == m["tokens"] / m["elapsed_s"]
    gw.reset_metrics()
    time.sleep(0.5)
    assert gw.metrics()["elapsed_s"] == 0.0
    t0 = time.monotonic()
    gw.step()
    assert gw.metrics()["elapsed_s"] <= time.monotonic() - t0 + 0.05
