"""The port's MoE (moonshot, llama4's interleaved pairs) and
encoder-decoder (seamless) models against the JAX reference on their
SMOKE configs.

Weights come from the reference's ``init(PRNGKey(0), cfg)`` and cross to
torch as numpy.  In float32 with TF32 off the port's loss, prefill logits
and float caches (k, v and the cross xk, xv), and 6 plain and 6 sealed
decode steps (fed the reference's greedy tokens) agree with the reference
within 1e-4, and the greedy tokens are equal.  Sealing is crypto and is
held bit for bit, at a nonce whose 2n / 4n lanes wrap mod 2^32: the
port's seal of the reference's plaintext prefill caches equals the
reference's ciphertext; one decode slot sealed by the port (the unit's
layer index j in its rows for llama4's pairs, the four nonces a layer for
the encoder-decoder) equals the reference's slot; the port's seal_tree of
each weight tree equals the reference's leaf for leaf.  ``moe_ffn`` alone
drops the reference's tokens at a capacity that drops, in both dispatch
branches.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import cipher as jcipher  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import sealed as jsealed  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import cipher  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import sealed as tsealed  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
         "seamless-m4t-large-v2")
KEY_WORDS = np.array([0x0BADF00D, 0xC0FFEE11], np.uint32)
NONCE = 0x40000003          # 2n and 4n wrap mod 2^32
B, S, T_SRC, N_DEC = 2, 8, 7, 6
TOL = dict(rtol=1e-4, atol=1e-4)


def to_np(t) -> np.ndarray:
    """A port tensor (int32/int16 bits as uint) or a jax array as numpy."""
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.int32, torch.int16):
            return t.numpy().view({torch.int32: np.uint32,
                                   torch.int16: np.uint16}[t.dtype])
        return t.detach().numpy()
    return np.asarray(t)


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype in (np.uint32, np.uint16):
        a = a.view({np.uint32: np.int32, np.uint16: np.int16}[a.dtype.type])
    return torch.from_numpy(a.copy())


def port_state(jstate: dict) -> dict:
    return {k: (int(v) if k in ("pos", "nonce") else to_torch(v))
            for k, v in jstate.items()}


def fields(cfg) -> tuple:
    return ("k", "v", "xk", "xv") if cfg.family == "encdec" else ("k", "v")


def field_nonce(cfg, nonce: int, layer: int, i: int) -> int:
    """The nonce of field i (k, v, xk, xv) of a unit or decoder layer."""
    if cfg.family == "encdec":
        return tencdec._nonces(nonce, layer)[i]
    return ttransformer._kv_nonces(nonce, layer)[i]


def unseal_cache(cfg, cache, key) -> dict:
    """The port's plaintext of a sealed cache, layer by layer."""
    out = {}
    for i, f in enumerate(fields(cfg)):
        ct = cache[f + "_ct"]
        out[f] = torch.stack([
            cipher.unseal_bits(ct[l], key,
                               field_nonce(cfg, cache["nonce"], l, i),
                               torch.float32)
            for l in range(ct.shape[0])])
    return out


def make_batch(cfg, rng) -> dict:
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "frame":
        batch["frame_embeds"] = rng.standard_normal(
            (B, T_SRC, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """One architecture: weights, inputs and the reference's outputs."""
    arch = request.param
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    jmodel = jregistry.get_model(jcfg)
    np_params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    rng = np.random.RandomState(11)
    batch = make_batch(jcfg, rng)
    labels = rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    jkey = jnp.asarray(KEY_WORDS)
    T = S + N_DEC + 2
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    ref = {"loss": float(jax.jit(lambda p, b: jmodel.loss(p, jcfg, b))(
        jparams, {**jb, "labels": jnp.asarray(labels)}))}
    prefill = jax.jit(lambda p, b, n, sealed: jmodel.prefill(
        p, jcfg, b, T, seal_ctx=(jkey, n) if sealed else None),
        static_argnums=3)
    decode = jax.jit(lambda p, st, t, sealed: jmodel.decode_step(
        p, jcfg, st, t, seal_ctx=(jkey, st["nonce"]) if sealed else None),
        static_argnums=3)
    for sealed in (False, True):
        logits, state = prefill(jparams, jb, jnp.uint32(NONCE), sealed)
        ref[sealed] = {"prefill_logits": np.asarray(logits),
                       "prefill_state": jax.tree_util.tree_map(np.asarray,
                                                               state),
                       "tokens": [], "logits": [], "states": []}
        for _ in range(N_DEC):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            ref[sealed]["tokens"].append(np.asarray(tok))
            logits, state = decode(jparams, state, tok, sealed)
            ref[sealed]["logits"].append(np.asarray(logits))
            ref[sealed]["states"].append(
                jax.tree_util.tree_map(np.asarray, state))
        ref[sealed]["state"] = ref[sealed]["states"][-1]
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                np_params=np_params,
                tparams=tregistry.params_from_numpy(np_params, "cpu"),
                batch=batch, labels=labels, ref=ref, T=T,
                tkey=torch.from_numpy(KEY_WORDS.view(np.int32).copy()))


def tbatch(case) -> dict:
    return {k: torch.from_numpy(v) for k, v in case["batch"].items()}


def test_loss_matches_reference(case):
    model = tregistry.get_model(case["tcfg"])
    with torch.no_grad():
        got = model.loss(case["tparams"], case["tcfg"],
                         {**tbatch(case),
                          "labels": torch.from_numpy(case["labels"])})
    np.testing.assert_allclose(float(got), case["ref"]["loss"], **TOL)


def test_prefill_logits_and_float_caches_match_reference(case):
    cfg = case["tcfg"]
    logits, cache = tregistry.get_model(cfg).prefill(
        case["tparams"], cfg, tbatch(case), case["T"])
    want = case["ref"][False]
    np.testing.assert_allclose(logits.numpy(), want["prefill_logits"], **TOL)
    assert cache["pos"] == int(want["prefill_state"]["pos"]) == S
    for f in fields(cfg):
        assert cache[f].dtype == torch.float32
        assert tuple(cache[f].shape) == want["prefill_state"][f].shape, f
        np.testing.assert_allclose(cache[f].numpy(),
                                   want["prefill_state"][f], **TOL)


@pytest.mark.parametrize("sealed", [False, True], ids=["plain", "sealed"])
def test_decode_steps_match_reference(case, sealed):
    """Six decode steps from the port's own prefill, fed the reference's
    greedy tokens: logits within 1e-4, the same greedy tokens, and the
    final caches' floats (unsealed by the port) within 1e-4 — a slot
    sealed under the wrong counter rows would unseal to noise."""
    cfg, key = case["tcfg"], case["tkey"]
    model = tregistry.get_model(cfg)
    want = case["ref"][sealed]
    seal_ctx = (key, NONCE) if sealed else None
    logits, state = model.prefill(case["tparams"], cfg, tbatch(case),
                                  case["T"], seal_ctx=seal_ctx)
    for tok, want_logits in zip(want["tokens"], want["logits"]):
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), tok)
        logits, state = model.decode_step(
            case["tparams"], cfg, state, torch.tensor(tok).long(),
            seal_ctx=(key, state["nonce"]) if sealed else None)
        np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    ref_state = port_state(want["state"])
    assert state["pos"] == ref_state["pos"] == S + N_DEC
    if sealed:
        assert state["nonce"] == ref_state["nonce"] == NONCE
        state, ref_state = (unseal_cache(cfg, s, key)
                            for s in (state, ref_state))
    for f in fields(cfg):
        np.testing.assert_allclose(state[f].numpy(), ref_state[f].numpy(),
                                   **TOL)


def test_prefill_seal_matches_reference_bit_for_bit(case):
    """The reference's plaintext prefill caches sealed by the port equal
    the reference's sealed caches, and the port's unseal returns them."""
    cfg, key = case["tcfg"], case["tkey"]
    plain = port_state(case["ref"][False]["prefill_state"])
    want = case["ref"][True]["prefill_state"]
    caches = tuple(plain[f] for f in fields(cfg))
    if cfg.family == "encdec":
        got = tencdec.seal_caches(caches, key, NONCE)
    else:
        got = ttransformer.seal_layers(*caches, key, NONCE)
    sealed = {f + "_ct": g for f, g in zip(fields(cfg), got)}
    sealed["nonce"] = NONCE
    assert int(want["nonce"]) == NONCE
    back = unseal_cache(cfg, sealed, key)
    for f in fields(cfg):
        assert tuple(sealed[f + "_ct"].shape) == want[f + "_ct"].shape
        np.testing.assert_array_equal(to_np(sealed[f + "_ct"]),
                                      want[f + "_ct"])
        np.testing.assert_array_equal(back[f].numpy().view(np.uint32),
                                      to_np(plain[f]).view(np.uint32))


def test_decode_slot_seal_matches_reference_bit_for_bit(case):
    """Each sealed decode step's new slot: the reference's plaintext of it
    (unsealed by the reference) sealed by the port under the port's slot
    rows and nonces equals the reference's ciphertext, for every unit or
    layer and, in llama4's pairs, both layers of a unit."""
    cfg, key = case["tcfg"], case["tkey"]
    jkey = jnp.asarray(KEY_WORDS)
    for step, st in enumerate(case["ref"][True]["states"]):
        pos = S + step
        for i, f in enumerate(("k", "v")):
            ct = st[f + "_ct"]
            for l in range(ct.shape[0]):
                nonce = field_nonce(cfg, NONCE, l, i)
                plain = np.asarray(jcipher.unseal_bits(
                    jnp.asarray(ct[l]), jkey, jnp.uint32(nonce),
                    jnp.float32))
                if cfg.family == "encdec":
                    T, K = ct.shape[2:4]
                    slot = plain[:, pos:pos + 1]
                    rows = ttransformer._slot_rows(B, T, K, pos, "cpu")
                    want = ct[l][:, pos:pos + 1]
                else:
                    lpu, _, T, K = ct.shape[1:5]
                    slot = plain[:, :, pos:pos + 1]
                    rows = tmoe._slot_rows(lpu, B, T, K, pos, "cpu")
                    want = ct[l][:, :, pos:pos + 1]
                got = cipher.seal_bits_slice(torch.tensor(slot), key,
                                             nonce, rows)
                np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("shards", [0, 2], ids=["global", "shard_local"])
@pytest.mark.parametrize("arch", ARCHS[:2])
def test_moe_ffn_drops_match_reference(arch, shards):
    """moe_ffn alone at capacity factor 0.5 (tokens dropped) in the global
    and the shard-local dispatch: the same output as the reference."""
    base = jconfigs.get_config(arch, smoke=True)
    jcfg = base.with_(moe=dataclasses.replace(base.moe, capacity_factor=0.5),
                      moe_dispatch_shards=shards)
    tcfg = tconfigs.get_config(arch, smoke=True)
    tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe, capacity_factor=0.5),
                      moe_dispatch_shards=shards)
    p = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_params(jax.random.PRNGKey(3), jcfg))
    x = np.random.RandomState(5).standard_normal(
        (4, 32, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jmoe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, p),
                                   jcfg, jnp.asarray(x)))
    got = tmoe.moe_ffn(tregistry.params_from_numpy(p, "cpu"), tcfg,
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # 128 tokens: tokens were dropped (a capacity that holds every token
    # gives another output)
    full = tmoe.moe_ffn(tregistry.params_from_numpy(p, "cpu"),
                        tcfg.with_(moe=dataclasses.replace(
                            tcfg.moe, capacity_factor=8.0)),
                        torch.from_numpy(x))
    assert not torch.allclose(got, full)


def test_seal_tree_matches_reference(case):
    """The port's seal_tree of the weight tree equals the reference's:
    the same leaf order under the new nested keys, the same nonces,
    ciphertext and tags."""
    jkey = jnp.asarray(KEY_WORDS)
    js = jsealed.seal_tree(case["jparams"], jkey, jpolicy.SealedSpec(), 7)
    ts = tsealed.seal_tree(case["tparams"], case["tkey"],
                           tpolicy.SealedSpec(), 7)
    jl = jax.tree_util.tree_leaves(js, is_leaf=jsealed.is_sealed)
    tl = tsealed.tree_leaves(ts)
    assert len(jl) == len(tl) == len(jax.tree_util.tree_leaves(
        case["np_params"]))
    for j, t in zip(jl, tl):
        assert int(j.nonce) == t.nonce
        np.testing.assert_array_equal(np.asarray(j.ct), to_np(t.ct))
        np.testing.assert_array_equal(np.asarray(j.tags), to_np(t.tags))


def test_encdec_cross_kv_is_source_length_and_unmasked():
    """The cross KV is sealed at the source length, with no padding; a
    source longer than the self cache still decodes."""
    cfg = tconfigs.get_config("seamless-m4t-large-v2", smoke=True)
    params = tencdec.init(torch.Generator().manual_seed(3), cfg, "cpu")
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 3), generator=g),
             "frame_embeds": torch.randn((1, 21, cfg.d_model), generator=g)}
    key = torch.tensor([5, 6], dtype=torch.int32)
    _, cache = tencdec.prefill(params, cfg, batch, 6, seal_ctx=(key, 9))
    nd, K, hd = cfg.encdec.n_dec_layers, cfg.n_kv_heads, cfg.hd
    assert tuple(cache["k_ct"].shape) == (nd, 1, 6, K, hd)
    assert tuple(cache["xk_ct"].shape) == (nd, 1, 21, K, hd)
    for _ in range(3):
        logits, cache = tencdec.decode_step(
            params, cfg, cache, batch["tokens"][:, 0], seal_ctx=(key, 9))
        assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="past the 6-slot cache"):
        tencdec.decode_step(params, cfg, cache, batch["tokens"][:, 0],
                            seal_ctx=(key, 9))
