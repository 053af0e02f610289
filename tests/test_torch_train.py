"""The port's sealed training against the JAX package.

granite-3-2b's smoke config in float32, weights from the reference's
``init``, one channel key and one optimizer (a cosine schedule, weight
decay 0.1) on both sides.  Bit for bit: the sealed state (ciphertext, tags,
nonces), the synthetic batches and the schedule (but for its cosine, where
XLA's f32 cos and torch's part in the last bits).  Close: one ``AdamW.apply``
on numpy gradients (1e-6), loss and gradient norm over three sealed steps
of two microbatches (1e-4 relative) and the plaintext state after them
(moments entry by entry, relative; parameters by their move from the
initial state), in place or not.  Behaviour: a tampered ``mu`` poisons the
state as in the reference; a checkpoint the reference saves restores in the
port to the same tensors (and the port writes the reference's manifest), a
wrong key or a flipped chunk byte is rejected; ``Supervisor`` with a
failure, a restart and forced lane refreshes gives the reference's
``events``; an in-place step consumes its input, and no restart ever puts
two ciphertexts under one leaf nonce.
"""
import glob

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import sealed as jsealed  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.optim import AdamW as JAdamW, TrainState as JTrainState  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import make_train_step as jmake_step  # noqa: E402
from repro.train import seal_state as jseal_state  # noqa: E402
from repro.train import unseal_state_host as junseal  # noqa: E402
from repro.train import make_refresh_fn as jrefresh_fn  # noqa: E402
from repro.train.fault import FailureInjector as JInjector  # noqa: E402
from repro.train.fault import Supervisor as JSupervisor  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import sealed as tsealed  # noqa: E402
from repro_torch.data import SyntheticLM, sealed_host_batches  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.optim import AdamW, TrainState, cosine_schedule  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import (make_eval_step, make_refresh_fn,  # noqa: E402
                               make_train_step, seal_state,
                               unseal_state_host)
from repro_torch.train.fault import FailureInjector, Supervisor  # noqa: E402

torch.set_num_threads(1)

KEY = np.array([0x5EC0DE, 0xFACADE], np.uint32)
KB = b"\xabK" * 16
SEQ, BATCH, ACCUM = 16, 2, 2


LR = 1e-3                               # peak of the cosine schedule


def jopt():
    return JAdamW(lr=jcosine(LR, 2, 10), weight_decay=0.1)


def topt():
    return AdamW(lr=cosine_schedule(LR, 2, 10), weight_decay=0.1)


def t_of(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "u":
        a = a.view({4: np.int32, 2: np.int16}[a.itemsize])
    return torch.from_numpy(a.copy())


def leaves(state) -> list:
    """A state's leaves in the reference's order, as numpy."""
    if isinstance(state, TrainState):
        return [tckpt._to_numpy(x, u) for _, x, u in tckpt._flatten(state)]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


@pytest.fixture(scope="module")
def side():
    """(jax, torch) dicts of cfg, key, sec, params, sealed state, step."""
    jcfg = jconfigs.get_config("granite-3-2b", smoke=True)
    model = registry.get_model(jcfg)
    jparams = model.init(jax.random.PRNGKey(0), jcfg)
    jkey = jnp.asarray(KEY)
    jsec = jpolicy.SecurityConfig()
    j = dict(cfg=jcfg, model=model, key=jkey, sec=jsec, params=jparams,
             state=jseal_state(jopt().init(jparams), jkey, jsec),
             step=jax.jit(jmake_step(model, jcfg, jopt(), jsec, jkey)))
    tcfg = tconfigs.get_config("granite-3-2b", smoke=True)
    tparams = ttransformer.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tkey = t_of(KEY)
    tsec = tpolicy.SecurityConfig()
    t = dict(cfg=tcfg, key=tkey, sec=tsec, params=tparams,
             state=seal_state(topt().init(tparams), tkey, tsec),
             step=make_train_step(ttransformer, tcfg, topt(), tsec, tkey))
    return j, t


def batches(i):
    mb = JSyntheticLM(vocab=512, seq_len=SEQ, batch=BATCH).microbatches_at(
        i, ACCUM)
    return ({k: jnp.asarray(v) for k, v in mb.items()},
            {k: torch.from_numpy(v) for k, v in mb.items()})


def test_sealed_state_matches_reference_bit_for_bit(side):
    j, t = side
    jl, tl = leaves(j["state"]), leaves(t["state"])
    assert len(jl) == len(tl) == 109
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 7])
def test_synthetic_batches_match_reference(step):
    j = JSyntheticLM(vocab=97, seq_len=16, batch=4, seed=3)
    t = SyntheticLM(vocab=97, seq_len=16, batch=4, seed=3)
    for a, b in ((j.batch_at(step), t.batch_at(step)),
                 (j.microbatches_at(step, 3), t.microbatches_at(step, 3))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_cosine_schedule_matches_reference():
    """Bit for bit in the warm-up and past the end; within two f32 ulps on
    the cosine, where XLA's f32 cos and torch's differ in the last bit for
    a few inputs (neither is the correctly rounded cos everywhere)."""
    j, t = jcosine(3e-4, 5, 40), cosine_schedule(3e-4, 5, 40)
    steps = np.arange(0, 48, dtype=np.int32)
    want = np.asarray(jax.vmap(j)(jnp.asarray(steps)))
    got = t(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    flat = (steps <= 5) | (steps >= 40)
    np.testing.assert_array_equal(got[flat], want[flat])
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def test_adamw_apply_matches_reference(side):
    """One update on numpy gradients and moments, clipped (the gradients'
    norm is above 1) and decayed, stacked norm scales included."""
    j, t = side
    rng = np.random.RandomState(4)
    np_params = jax.tree_util.tree_map(np.asarray, j["params"])
    mk = lambda s: jax.tree_util.tree_map(  # noqa: E731
        lambda p: (rng.standard_normal(p.shape) * s).astype(np.float32),
        np_params)
    g, mu, nu = mk(0.1), mk(0.01), jax.tree_util.tree_map(np.abs, mk(1e-3))
    js = JTrainState(step=jnp.asarray(3, jnp.int32), params=j["params"],
                     mu=mu, nu=nu)
    jnew, jm = jopt().apply(js, g)
    tt = lambda tree: ttransformer.params_from_numpy(tree, "cpu")  # noqa
    ts = TrainState(step=torch.tensor(3, dtype=torch.int32),
                    params=t["params"], mu=tt(mu), nu=tt(nu))
    tnew, tm = topt().apply(ts, tt(g))
    assert float(jm["grad_norm"]) > 1.0
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert int(tnew.step) == int(jnew.step) == 4
    for a, b in zip(leaves(jnew)[1:], leaves(tnew)[1:]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    # the stacked ln1 scales (ndim 2) decay, the final norm does not
    assert not np.allclose(tnew.params["layers"]["ln1"].numpy(), 1.0)
    assert tnew.params["final_norm"].shape == (128,)


def test_loss_and_grads_match_reference(side):
    j, t = side
    jb, tb = batches(0)
    mb_j = {k: v[0] for k, v in jb.items()}
    mb_t = {k: v[0] for k, v in tb.items()}
    jl, jg = jax.value_and_grad(
        lambda p: j["model"].loss(p, j["cfg"], mb_j))(j["params"])
    leaves_t = [p.clone().requires_grad_(True)
                for p in tsealed.tree_leaves(t["params"])]
    tl = ttransformer.loss(tsealed.tree_unflatten(t["params"], leaves_t),
                           t["cfg"], mb_t)
    tg = torch.autograd.grad(tl, leaves_t)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def three_steps(side):
    """Three sealed steps of each package: (losses, grad norms, final
    state) for jax and for the port."""
    j, t = side
    out = {}
    for name, s in (("jax", j), ("torch", t)):
        state, losses, norms = s["state"], [], []
        for i in range(3):
            state, m = s["step"](state, batches(i)[name == "torch"])
            assert bool(m["seal_ok"])
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = (losses, norms, state)
    return out


def test_three_sealed_steps_match_reference(side, three_steps):
    """Loss and gradient norm within 1e-4 relative.  The state after the
    steps: each moment entry within a relative limit (mu 1e-3, nu 2e-4;
    the worst read here is 1.7e-4 and 5.1e-5) plus a floor of 1e-5 of its
    leaf's largest entry.  The parameters by their move from the initial
    state, in two parts.  Adam scales each step by the gradient's running
    RMS, so where a gradient nearly cancels over the steps a last-bit
    difference between XLA's f32 gradient and torch's moves the parameter
    by a small share of lr either way: every move is within 1e-3 of the
    reference's plus 2 % of the summed lr (the worst read here is 0.9 %),
    and all but 1e-3 of the entries (5.3e-4 read here) within 1e-3
    relative plus 1e-6 of the leaf's largest move, which any systematic
    fault in the update would break."""
    j, t = side
    (jl, jn, js), (tl, tn, ts) = three_steps["jax"], three_steps["torch"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)
    jp = junseal(js, j["key"], j["sec"])
    tp = unseal_state_host(ts, t["key"], t["sec"])
    assert int(tp.step) == int(jp.step) == 3
    ja = [np.asarray(x, np.float64) for x in
          jax.tree_util.tree_leaves((jp.params, jp.mu, jp.nu))]
    ta = [x.numpy().astype(np.float64) for x in
          tsealed.tree_leaves((tp.params, tp.mu, tp.nu))]
    p0 = [np.asarray(x, np.float64)
          for x in jax.tree_util.tree_leaves(j["params"])]
    n = len(p0)
    for i in range(n, 3 * n):                          # mu, then nu
        np.testing.assert_allclose(ta[i], ja[i],
                                   rtol=1e-3 if i < 2 * n else 2e-4,
                                   atol=1e-5 * np.abs(ja[i]).max())
    sched = cosine_schedule(LR, 2, 10)
    lr_sum = sum(float(sched(torch.tensor(i))) for i in range(3))
    off = total = 0
    for a0, a, b in zip(p0, ja[:n], ta[:n]):
        dj, dt = a - a0, b - a0
        err = np.abs(dt - dj)
        assert (err <= 1e-3 * np.abs(dj) + 0.02 * lr_sum).all()
        off += int((err > 1e-3 * np.abs(dj) + 1e-6 * np.abs(dj).max()).sum())
        total += dj.size
    assert off <= 1e-3 * total, (off, total)
    # the nonces moved one lane per step, as in the reference
    for a, b in zip(leaves(js), leaves(ts)):
        if a.ndim == 0 and a.dtype == np.uint32:
            assert int(a) == int(b)


def state_copy(s0: TrainState) -> TrainState:
    """A sealed state on buffers of its own (an in-place step overwrites
    the ones it is given)."""
    def copy(st):
        return tsealed.SealedTensor(st.ct.clone(), st.tags.clone(), st.nonce,
                                    st.dtype, st.spec)

    return TrainState(s0.step.clone(), *(
        tsealed.tree_unflatten(tree, [copy(x) for x in
                                      tsealed.tree_leaves(tree)])
        for tree in (s0.params, s0.mu, s0.nu)))


def test_in_place_step_equals_the_default(side, three_steps):
    """Resealing into the old ciphertext computes the same state; the
    consumed input refuses a second use."""
    _, t = side
    step = make_train_step(ttransformer, t["cfg"], topt(), t["sec"],
                           t["key"], in_place=True)
    state = first = state_copy(t["state"])
    for i in range(3):
        state, m = step(state, batches(i)[1])
        assert bool(m["seal_ok"])
    for a, b in zip(leaves(three_steps["torch"][2]), leaves(state)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(tsealed.ConsumedSealedTensor):
        unseal_state_host(first, t["key"], t["sec"])
    with pytest.raises(tsealed.ConsumedSealedTensor):
        step(first, batches(0)[1])


@pytest.mark.parametrize("save_at_start", [False, True])
def test_in_place_restart_never_reuses_a_nonce(side, three_steps, tmp_path,
                                               save_at_start):
    """``Supervisor`` over the in-place step, with a failure at step 1,
    before any periodic checkpoint.  Without a checkpoint of the entry state
    the restart finds it consumed and stops; with one it restores and
    replays to the three-step state.  Either way no leaf nonce ever carries
    two different ciphertexts (two plaintexts under one keystream)."""
    _, t = side
    step = make_train_step(ttransformer, t["cfg"], topt(), t["sec"],
                           t["key"], in_place=True)
    written = {}

    def stepper(s, b):
        s, m = step(s, b)
        for i, st in enumerate(tsealed.tree_leaves((s.params, s.mu, s.nu))):
            first = written.setdefault((i, st.nonce), st.ct.clone())
            assert torch.equal(first, st.ct), (i, st.nonce)
        return s, m

    sup = Supervisor(step_fn=stepper, batch_fn=lambda i: batches(i)[1],
                     ckpt_dir=str(tmp_path), key_bytes=KB, save_every=10,
                     injector=FailureInjector(fail_at_steps=(1,)),
                     save_at_start=save_at_start)
    if not save_at_start:
        with pytest.raises(tsealed.ConsumedSealedTensor):
            sup.run(state_copy(t["state"]), 3)
        # step 0's leaves only: the replay refused before writing
        assert len(written) == 3 * len(tsealed.tree_leaves(t["params"]))
        return
    state, _, events = sup.run(state_copy(t["state"]), 3)
    assert events == {"failures": 1, "restarts": 1, "stragglers": 0,
                      "saves": 2, "lane_refreshes": 0}
    for a, b in zip(leaves(three_steps["torch"][2]), leaves(state)):
        np.testing.assert_array_equal(a, b)


def test_tampered_mu_poisons_output(side):
    """A flipped word of one sealed mu leaf: seal_ok False and every
    parameter NaN, in both packages."""
    j, t = side
    jleaves, treedef = jax.tree_util.tree_flatten(
        j["state"].mu, is_leaf=lambda x: isinstance(x, jsealed.SealedTensor))
    st = jleaves[0]
    jleaves[0] = jsealed.SealedTensor(
        st.ct.ravel().at[5].add(1).reshape(st.ct.shape), st.tags, st.nonce,
        st.dtype, st.spec)
    js = JTrainState(step=j["state"].step, params=j["state"].params,
                     mu=jax.tree_util.tree_unflatten(treedef, jleaves),
                     nu=j["state"].nu)
    js2, jm = j["step"](js, batches(0)[0])
    tl = tsealed.tree_leaves(t["state"].mu)
    ct = tl[0].ct.clone()
    ct.view(-1)[5] += 1
    tl = [tsealed.SealedTensor(ct, *[getattr(tl[0], f) for f in
                                     ("tags", "nonce", "dtype", "spec")])
          ] + tl[1:]
    ts = TrainState(step=t["state"].step, params=t["state"].params,
                    mu=tsealed.tree_unflatten(t["state"].mu, tl),
                    nu=t["state"].nu)
    ts2, tm = t["step"](ts, batches(0)[1])
    assert not bool(jm["seal_ok"]) and not bool(tm["seal_ok"])
    jp, _ = jsealed.unseal_tree(js2.params, j["key"])
    tp, _ = tsealed.unseal_tree(ts2.params, t["key"])
    for a, b in zip(jax.tree_util.tree_leaves(jp), tsealed.tree_leaves(tp)):
        assert np.isnan(np.asarray(a)).all() and torch.isnan(b).all()


def test_sealed_batch_gives_the_plain_batch_step(side, three_steps):
    _, t = side
    plain = batches(0)[1]
    sealed = [sealed_host_batches({k: v[i] for k, v in plain.items()},
                                  t["key"], t["sec"].activations, 1000 + i)
              for i in range(ACCUM)]
    assert tsealed.is_sealed(sealed[0]["tokens"])
    _, m = t["step"](t["state"], sealed)
    assert float(m["loss"]) == three_steps["torch"][0][0]


def test_eval_step_matches_reference_loss(side):
    j, t = side
    jb, tb = batches(5)
    mb_j = {k: v[0] for k, v in jb.items()}
    jl = j["model"].loss(j["params"], j["cfg"], mb_j)
    tl = make_eval_step(ttransformer, t["cfg"], t["sec"], t["key"])(
        t["state"], {k: v[0] for k, v in tb.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_reference_checkpoint_restores_in_the_port(side, tmp_path):
    j, t = side
    jpath = jckpt.save(str(tmp_path / "jax"), 3, j["state"], KB)
    restored, step_no = tckpt.restore(jpath, t["state"], KB)
    assert step_no == 3
    for a, b in zip(leaves(t["state"]), leaves(restored)):
        np.testing.assert_array_equal(a, b)
    # the port writes the reference's manifest: same keys, shapes, dtypes
    tpath = tckpt.save(str(tmp_path / "torch"), 3, restored, KB)
    jman = jckpt.SealedStore(str(tmp_path / "jax")).manifest("ckpt_000003")
    tman = tckpt.SealedStore(str(tmp_path / "torch")).manifest("ckpt_000003")
    assert tman["meta"] == jman["meta"]
    assert tman["chunks"] == jman["chunks"]
    assert tman["merkle_root"] == jman["merkle_root"]
    back, _ = jckpt.restore(tpath, j["state"], KB)
    for a, b in zip(leaves(j["state"]), leaves(back)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(tckpt.CheckpointError):
        tckpt.restore(jpath, t["state"], b"wrong" * 8)
    f = sorted(glob.glob(jpath + "/0000*.npy"))[2]
    arr = np.load(f).reshape(-1)
    arr[0] ^= 1
    np.save(f, arr)
    with pytest.raises(tckpt.CheckpointError):
        tckpt.restore(jpath, t["state"], KB)


def test_checkpoint_is_a_store_object(tmp_path):
    """tests/test_store.py's case on the port."""
    state = {"w": torch.arange(12, dtype=torch.float32),
             "b": torch.ones((3,))}
    path = tckpt.save(str(tmp_path), 7, state, KB)
    man = tckpt.SealedStore(str(tmp_path)).manifest("ckpt_000007")
    assert man["kind"] == "checkpoint" and man["freshness"] == 7
    assert [c["name"] for c in man["chunks"]] == ["000000", "000001"]
    assert man["meta"]["keys"] == ["['b']", "['w']"]
    restored, step = tckpt.restore(path, state, KB)
    assert step == 7 and torch.equal(restored["w"], state["w"])
    assert tckpt.fsck(str(tmp_path), KB) == {"ok": ["ckpt_000007"],
                                             "corrupt": []}


@pytest.mark.parametrize("fail_at, limit", [((), 3), ((4,), 50)])
def test_supervisor_lane_guard_matches_reference(tmp_path, fail_at, limit):
    """tests/test_store.py's lane-guard cases: refreshes when the budget is
    spent, and one forced by the restore after a failure."""
    events = []
    for pkg, sup_cls, inj, sealed_mod, zero in (
            ("jax", JSupervisor, JInjector, jsealed, jnp.zeros(())),
            ("torch", Supervisor, FailureInjector, tsealed,
             torch.zeros(()))):
        refreshes = []
        sup = sup_cls(step_fn=lambda s, b: (s + 1, {"loss": s}),
                      batch_fn=lambda i: i, ckpt_dir=str(tmp_path / pkg),
                      key_bytes=KB, save_every=100,
                      injector=inj(fail_at_steps=fail_at),
                      lane_guard=sealed_mod.ResealCounter(limit=limit),
                      refresh_fn=lambda s: refreshes.append(1) or s)
        _, _, ev = sup.run(zero, n_steps=10 if not fail_at else 8)
        assert ev["lane_refreshes"] == len(refreshes) >= 1
        events.append(ev)
    assert events[0] == events[1]


def test_supervisor_failure_restart_and_refresh_match_reference(side,
                                                                tmp_path):
    """Sealed smoke training through Supervisor: a failure at step 2, the
    restore of the step-2 checkpoint, lane refreshes forced by it and by a
    budget of 2 — the same events and losses as the reference."""
    j, t = side
    runs = {}
    for name, s, sup_cls, inj, guard, refresh in (
            ("jax", j, JSupervisor, JInjector, jsealed.ResealCounter,
             jrefresh_fn),
            ("torch", t, Supervisor, FailureInjector, tsealed.ResealCounter,
             make_refresh_fn)):
        losses = []

        def stepper(state, b, s=s, losses=losses):
            state, m = s["step"](state, b)
            losses.append(float(m["loss"]))
            return state, m

        sup = sup_cls(step_fn=stepper,
                      batch_fn=lambda i, n=name: batches(i)[n == "torch"],
                      ckpt_dir=str(tmp_path / name), key_bytes=KB,
                      save_every=2, injector=inj(fail_at_steps=(2,)),
                      lane_guard=guard(limit=2),
                      refresh_fn=refresh(s["key"], s["sec"]))
        state, _, events = sup.run(s["state"], 4)
        runs[name] = (losses, events, state)
    (jl, je, js), (tl, te, ts) = runs["jax"], runs["torch"]
    assert te == je and te["failures"] == 1 and te["lane_refreshes"] >= 1
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for a, b in zip(leaves(js), leaves(ts)):
        if a.ndim == 0 and a.dtype == np.uint32:       # nonces: same lanes
            assert int(a) == int(b)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    events = tlaunch.main(["--arch", "granite-3-2b", "--device", "cpu",
                           "--steps", "3", "--seq", "16", "--batch", "2",
                           "--fail-at", "1", "--ckpt-dir", str(tmp_path)])
    assert events["failures"] == 1 and events["restarts"] == 1
    out = capsys.readouterr().out
    assert out.count("seal_ok=True") == 4


def test_launcher_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "granite-3-2b", "--steps", "1"])
