"""The port's four examples (``examples/*_torch.py``) against the JAX
package, on the CPU.

Each example's ``run`` takes the reference's parameters (its ``init`` on
the smoke configs, float32, TF32 off) as numpy, and the same flow runs
through the reference's API in this process:

* quickstart: section 3's greedy tokens equal the reference
  ``ServeEngine``'s, the tampered ciphertext fails verification, and
  sections 5 and 6 give the reference gateways' streams, statuses, swaps,
  page closes and prefill chunks;
* secure_serving: the sealed tokens equal the plaintext engine's and the
  reference engine's;
* secure_training: the losses of every executed step, replays included,
  within 1e-5 relative of the reference flow's, and the same Supervisor
  events (both Supervisors read one fake clock, so no step counts as a
  straggler by chance);
* multipod: two gloo processes through ``torch_dist.spawn``; each pod's
  first loss equals the reference model's loss on that pod's half of the
  batch, both pods hold the same sealed state after every step, and the
  loss falls on both.

The reference's sealed serving and sealed train step compile for one to
two minutes each here, so its engines, gateways and train step run with
security off.  Sealing is exact, so tokens, statuses and losses do not
depend on it (the reference's own secure_serving example asserts sealed ==
plaintext); the port's runs are sealed.  The reference's sealed-byte
counters count nothing with security off: the quickstart's sealed bytes
per decode token are held to the reference pool's accounting rule
(``repro/serve/kv_pager.py``, ``note_decode`` and ``note_close``) over the
reference's own counts, and the trusted gateway's counters to the
reference's in ``tests/test_torch_gateway.py``.
"""
import json
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import SecureChannel as JChannel  # noqa: E402
from repro.core.policy import SecurityConfig as JSecurityConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.serve import SecureGateway as JGateway  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.train import fault as jfault  # noqa: E402
from repro.train import make_train_step as jmake_step  # noqa: E402
from repro.train import seal_state as jseal_state  # noqa: E402
from repro_torch.train import fault as tfault  # noqa: E402

from torch_dist import ROOT, spawn  # noqa: E402

sys.path.insert(0, str(ROOT / "examples"))
import multipod_training_torch as multipod  # noqa: E402
import quickstart_torch as quickstart  # noqa: E402
import secure_serving_torch as serving  # noqa: E402
import secure_training_torch as training  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EXAMPLES = (quickstart, serving, training, multipod)
KEY_WORDS = [0x5EC0DE, 0xFACADE]
KEY_BYTES = b"\xabK" * 16
TRAIN = dict(steps=6, dim=64, layers=2, vocab=256, batch=4, seq=16)


def ref_params(arch: str, cfg=None) -> dict:
    cfg = cfg or jconfigs.get_config(arch, smoke=True)
    return jax.tree_util.tree_map(
        np.asarray, jregistry.get_model(cfg).init(jax.random.PRNGKey(0),
                                                  cfg))


def jtree(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


@pytest.fixture(scope="module")
def granite_np():
    return ref_params("granite-3-2b")


def ref_generate(arch, np_params, prompts, n_new, max_len):
    cfg = jconfigs.get_config(arch, smoke=True)
    eng = JServeEngine(cfg=cfg, params=jtree(np_params),
                       channel=JChannel.insecure(), max_len=max_len)
    return np.asarray(eng.generate({"tokens": prompts}, n_new=n_new))


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def ref_gateway_sections(np_params) -> dict:
    """Sections 5 and 6 of examples/quickstart.py on the reference
    gateway (security off: see the module docstring)."""
    scfg = jconfigs.get_config("granite-3-2b", smoke=True)
    sparams = jtree(np_params)
    gw = JGateway(scfg, sparams, security="off", max_slots=2, page_size=8,
                  n_pages=16, max_pages_per_seq=3)
    rng = np.random.RandomState(0)
    rid_a = gw.submit("alice", rng.randint(0, scfg.vocab, 5), max_new=6)
    rid_b = gw.submit("bob", rng.randint(0, scfg.vocab, 11), max_new=6)
    gw.drain()
    m = gw.metrics()
    pool = gw.pool
    sealed_decode = (m["decode_tokens"] * 2 * pool.slot_bytes
                     + m["page_closes"] * 2 * pool.page_bytes)
    out = {"alice": np.asarray(gw.collect(rid_a)),
           "bob": np.asarray(gw.collect(rid_b)),
           "gateway": {k: m[k] for k in ("tokens", "kv_pages_peak",
                                         "decode_tokens", "page_closes",
                                         "prefill_chunks")},
           "sealed_bytes_per_token": sealed_decode / m["decode_tokens"]}
    out["gateway"]["tenant_sessions"] = len(m["tokens_per_tenant"])
    gw2 = JGateway(scfg, sparams, security="off", max_slots=2, page_size=8,
                   n_pages=5, max_pages_per_seq=2)
    rids = [gw2.submit("batch", rng.randint(0, scfg.vocab, 9), max_new=4)
            for _ in range(2)]
    gw2.step()
    rids += [gw2.submit("live", rng.randint(0, scfg.vocab, 5), max_new=4,
                        priority=5) for _ in range(2)]
    rids += [gw2.submit("batch", rng.randint(0, scfg.vocab, 9), max_new=4)
             for _ in range(2)]
    gw2.drain()
    m2 = gw2.metrics()
    out["oversubscribed"] = {
        "requests": len(rids), "pages": gw2.pool.n_pages - 1,
        "statuses": [gw2.status(r) for r in rids],
        "swap_outs": m2["swap_outs"], "swap_ins": m2["swap_ins"],
        "occupancy_pct": m2["pool_occupancy_pct"],
        "tokens": [np.asarray(gw2.collect(r)).tolist() for r in rids]}
    return out


@pytest.fixture(scope="module")
def qs(granite_np):
    qwen_np = ref_params("qwen3-4b")
    got = quickstart.run("cpu", params=qwen_np, gateway_params=granite_np)
    ref = ref_gateway_sections(granite_np)
    ref["tokens"] = ref_generate("qwen3-4b", qwen_np, got["prompt"], 8, 48)
    return got, ref


def test_quickstart_serving_tokens_equal_the_reference_engine(qs):
    got, ref = qs
    assert got["tokens"].shape == (2, 8)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    # the reference's count of ciphertext words of qwen3-4b's smoke config
    n = sum(x.size for x in jax.tree_util.tree_leaves(
        ref_params("qwen3-4b")))
    assert got["ciphertext_words"] == n


def test_quickstart_tamper_is_detected(qs):
    assert qs[0]["tamper_ok"] is False


def test_quickstart_two_tenants_equal_the_reference_gateway(qs):
    got, ref = qs
    np.testing.assert_array_equal(got["alice"], ref["alice"])
    np.testing.assert_array_equal(got["bob"], ref["bob"])
    for k, v in ref["gateway"].items():
        assert got["gateway"][k] == v, k
    assert got["gateway"]["sealed_bytes_per_token"] == \
        ref["sealed_bytes_per_token"]


def test_quickstart_oversubscription_equals_the_reference_gateway(qs):
    got, ref = qs
    o = got["oversubscribed"]
    assert o == ref["oversubscribed"]
    assert o["statuses"].count("done") == 6
    assert (o["swap_outs"], o["swap_ins"]) == (2, 2)


def test_quickstart_prints_the_reference_lines(qs, monkeypatch, capsys):
    monkeypatch.setattr(quickstart, "run", lambda device: qs[0])
    quickstart.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "session established; register nonce=0"
    assert "tamper detected: ok=False" in "\n".join(lines)
    assert "6/6 done, swaps out/in 2/2" in lines[-1]


# ---------------------------------------------------------------------------
# secure serving
# ---------------------------------------------------------------------------

def test_secure_serving_equals_plaintext_and_the_reference(granite_np):
    got = serving.run("cpu", params=granite_np)
    assert got["sealed_equals_plain"]
    assert got["tokens"].shape == (serving.BATCH, serving.N_NEW)
    assert got["launches_verified"] == serving.N_NEW
    want = ref_generate("granite-3-2b", granite_np, got["prompts"],
                        serving.N_NEW, serving.MAX_LEN)
    np.testing.assert_array_equal(got["tokens"], want)
    np.testing.assert_array_equal(got["plain_tokens"], want)


# ---------------------------------------------------------------------------
# secure training
# ---------------------------------------------------------------------------

def fake_clock():
    """A ``time`` stand-in for the Supervisors: every step takes 1 s."""
    t = iter(range(1 << 30))
    return types.SimpleNamespace(perf_counter=lambda: float(next(t)))


def ref_training(np_params, tmp_path) -> tuple[list, dict]:
    """examples/secure_training.py's flow on the reference (security off:
    see the module docstring)."""
    a = TRAIN
    d = a["dim"]
    cfg = JModelConfig(
        arch_id="secure-train-demo", family="dense", n_layers=a["layers"],
        d_model=d, n_heads=d // 64, n_kv_heads=max(1, d // 128),
        d_ff=4 * d, vocab=a["vocab"], q_block=64, dtype="float32",
        param_dtype="float32")
    model = jregistry.get_model(cfg)
    sec = JSecurityConfig.off()
    opt = JAdamW(lr=3e-4, weight_decay=0.01)
    state = jseal_state(opt.init(jtree(np_params)), None, sec)
    step = jax.jit(jmake_step(model, cfg, opt, sec, None))
    data = JSyntheticLM(vocab=cfg.vocab, seq_len=a["seq"], batch=a["batch"])
    losses = []

    def stepper(s, b):
        s, m = step(s, b)
        losses.append(float(m["loss"]))
        return s, m

    sup = jfault.Supervisor(
        step_fn=stepper,
        batch_fn=lambda i: {k: jnp.asarray(v) for k, v in
                            data.microbatches_at(i, 2).items()},
        ckpt_dir=str(tmp_path), key_bytes=KEY_BYTES, save_every=10,
        injector=jfault.FailureInjector(fail_at_steps=(a["steps"] // 2,)),
        straggler=jfault.StragglerPolicy())
    _, _, events = sup.run(state, a["steps"])
    return losses, events


def test_secure_training_matches_the_reference_flow(tmp_path, monkeypatch):
    a = TRAIN
    cfg = training.demo_config(a["dim"], a["layers"], a["vocab"])
    jcfg = JModelConfig(**{f: getattr(cfg, f) for f in (
        "arch_id", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab", "q_block", "dtype", "param_dtype")})
    np_params = ref_params(None, jcfg)
    monkeypatch.setattr(jfault, "time", fake_clock())
    monkeypatch.setattr(tfault, "time", fake_clock())
    want_losses, want_events = ref_training(np_params, tmp_path / "ref")
    got = training.run("cpu", params=np_params, **a)
    assert got["events"] == want_events
    assert want_events["failures"] == want_events["restarts"] == 1
    # the failure at step 3 restarts from the initial state: 3 + 6 steps
    assert len(got["losses"]) == len(want_losses) == 9
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert all(got["seal_ok"]) and got["final_step"] == a["steps"]
    assert got["n_params"] == sum(x.size for x in
                                  jax.tree_util.tree_leaves(np_params))


# ---------------------------------------------------------------------------
# multipod
# ---------------------------------------------------------------------------

def _pod(rank: int, port: int, out_dir: str, np_params) -> None:
    torch.set_num_threads(1)
    res = multipod.train_pod(rank, port, KEY_WORDS, KEY_BYTES,
                             device="cpu", params=np_params)
    with open(f"{out_dir}/pod{rank}.json", "w") as f:
        json.dump(res, f)


def test_multipod_pods_agree_and_match_the_reference(granite_np, tmp_path):
    spawn(_pod, multipod.N_PODS, tmp_path, granite_np, timeout=240)
    pods = [json.loads((tmp_path / f"pod{p}.json").read_text())
            for p in range(multipod.N_PODS)]
    assert pods[0]["mesh"] == {"pod": 2, "data": 1, "model": 1}
    for p in pods:
        assert len(p["losses"]) == multipod.STEPS and all(p["seal_ok"])
        assert p["losses"][-1] < p["losses"][0]
    # the same sealed state on both pods after every step
    assert pods[0]["digests"] == pods[1]["digests"]
    assert len(set(pods[0]["digests"])) == multipod.STEPS
    # step 0: each pod's loss is the model's loss on its half of the batch
    cfg = jconfigs.get_config("granite-3-2b", smoke=True)
    model = jregistry.get_model(cfg)
    params = jtree(granite_np)
    mb = JSyntheticLM(vocab=cfg.vocab, seq_len=multipod.SEQ,
                      batch=multipod.BATCH).microbatches_at(0, 2)
    per = multipod.BATCH // multipod.N_PODS
    for p in pods:
        rows = slice(p["pod"] * per, (p["pod"] + 1) * per)
        want = np.mean([float(model.loss(params, cfg, {
            k: jnp.asarray(v[j, rows]) for k, v in mb.items()}))
            for j in range(2)])
        np.testing.assert_allclose(p["losses"][0], want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("example", EXAMPLES,
                         ids=[m.__name__ for m in EXAMPLES])
def test_example_refuses_the_card_without_one(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
