"""The port's rwkv, hybrid, VLM and qk-norm dense models against the JAX
reference on their SMOKE configs.

Weights come from the reference's ``init(PRNGKey(0), cfg)`` and cross to
torch as numpy.  In float32 with TF32 off the port's loss, prefill logits
and float state, and 6 plain and 6 sealed decode steps (fed the
reference's greedy tokens) agree with the reference within 1e-4, and the
greedy tokens are equal.  The state's sealing is crypto and is held bit
for bit: the port's seal of the reference's plaintext state equals the
reference's ciphertext, under a nonce whose 4n / 8n lane wraps mod 2^32,
and the port's unseal gives the plaintext back exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import cipher  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCHS = ("rwkv6-3b", "zamba2-1.2b", "internvl2-2b", "qwen3-4b")
KEY_WORDS = np.array([0x0BADF00D, 0xC0FFEE11], np.uint32)
NONCE = 0x40000003          # 4n and 8n wrap mod 2^32
B, S, N_DEC = 2, 8, 6
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
    """A reference state/cache dict as the port's: tensors, host-int pos
    and nonce."""
    return {k: (int(v) if k in ("pos", "nonce") else to_torch(v))
            for k, v in jstate.items()}


def float_fields(cfg) -> tuple:
    return {"rwkv": ("wkv", "tm_x", "cm_x"),
            "hybrid": ("ssm", "conv", "attn_k", "attn_v")}.get(
                cfg.family, ("k", "v"))


def max_len(cfg) -> int:
    n_front = cfg.n_frontend_tokens if cfg.frontend == "patch" else 0
    return n_front + S + N_DEC + 2


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
    batch = {"tokens": rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.frontend == "patch":
        batch["patch_embeds"] = rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    labels = rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    jkey = jnp.asarray(KEY_WORDS)
    T = max_len(jcfg)
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
                       "tokens": [], "logits": []}
        for _ in range(N_DEC):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            ref[sealed]["tokens"].append(np.asarray(tok))
            logits, state = decode(jparams, state, tok, sealed)
            ref[sealed]["logits"].append(np.asarray(logits))
        ref[sealed]["state"] = jax.tree_util.tree_map(np.asarray, state)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
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


def test_prefill_logits_and_float_state_match_reference(case):
    cfg = case["tcfg"]
    logits, state = tregistry.get_model(cfg).prefill(
        case["tparams"], cfg, tbatch(case), case["T"])
    want = case["ref"][False]
    np.testing.assert_allclose(logits.numpy(), want["prefill_logits"], **TOL)
    assert state["pos"] == int(want["prefill_state"]["pos"])
    for f in float_fields(cfg):
        assert state[f].dtype == torch.float32
        np.testing.assert_allclose(state[f].numpy(),
                                   want["prefill_state"][f], **TOL)


@pytest.mark.parametrize("sealed", [False, True], ids=["plain", "sealed"])
def test_decode_steps_match_reference(case, sealed):
    """Six decode steps from the port's own prefill, fed the reference's
    greedy tokens: logits within 1e-4, the same greedy tokens, and the
    final state's floats (unsealed by the port) within 1e-4."""
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
    n_front = cfg.n_frontend_tokens if cfg.frontend == "patch" else 0
    assert state["pos"] == ref_state["pos"] == n_front + S + N_DEC
    if sealed and cfg.family in ("rwkv", "hybrid"):
        assert state["nonce"] == ref_state["nonce"] == NONCE + N_DEC
        unseal = (trwkv._unseal_state_t if cfg.family == "rwkv"
                  else tssm._unseal_states)
        state, ref_state = (unseal(s, key, cfg) for s in (state, ref_state))
    elif sealed:
        state, ref_state = (unseal_cache(s, key) for s in (state, ref_state))
    for f in float_fields(cfg):
        np.testing.assert_allclose(state[f].numpy(), ref_state[f].numpy(),
                                   **TOL)


def unseal_cache(cache, key):
    """The port's plaintext of a sealed fixed-slot KV cache."""
    out = {}
    for name, sel in (("k", 0), ("v", 1)):
        ct = cache[name + "_ct"]
        out[name] = torch.stack([cipher_unseal(
            ct[l], key, ttransformer._kv_nonces(cache["nonce"], l)[sel])
            for l in range(ct.shape[0])])
    return out


def cipher_unseal(ct, key, nonce):
    return cipher.unseal_bits(ct, key, nonce, torch.float32)


def test_state_seal_matches_reference_bit_for_bit(case):
    """The reference's plaintext prefill state sealed by the port equals
    the reference's sealed state, and the port's unseal returns it."""
    cfg, key = case["tcfg"], case["tkey"]
    jkey = jnp.asarray(KEY_WORDS)
    plain = case["ref"][False]["prefill_state"]
    jplain = jax.tree_util.tree_map(jnp.asarray, plain)
    tplain = port_state(plain)
    if cfg.family == "rwkv":
        want = jrwkv._seal_state(jplain, (jkey, jnp.uint32(NONCE)))
        got = trwkv._seal_state(tplain, (key, NONCE))
        back = trwkv._unseal_state_t(got, key, cfg)
    elif cfg.family == "hybrid":
        want = jssm._seal_states(jplain, jkey, jnp.uint32(NONCE))
        got = tssm._seal_states(tplain, key, NONCE)
        back = tssm._unseal_states(got, key, cfg)
    else:
        want = case["ref"][True]["prefill_state"]
        k_ct, v_ct = ttransformer.seal_layers(tplain["k"], tplain["v"], key,
                                              NONCE)
        got = {"k_ct": k_ct, "v_ct": v_ct, "nonce": NONCE}
        back = unseal_cache(got, key)
        got = {"k": k_ct, "v": v_ct, "nonce": NONCE}
        want = {"k": want["k_ct"], "v": want["v_ct"], "nonce": want["nonce"]}
    assert got["nonce"] == int(want["nonce"]) == NONCE
    for f in float_fields(cfg):
        assert tuple(got[f].shape) == tuple(np.shape(want[f]))
        np.testing.assert_array_equal(to_np(got[f]), np.asarray(want[f]))
        np.testing.assert_array_equal(back[f].numpy().view(np.uint32),
                                      np.asarray(plain[f]).view(np.uint32))


def test_patch_embeddings_take_the_first_positions():
    """VLM: the projected patch embeddings precede the tokens and shift the
    decode positions by their count; without them the model is the dense
    backbone over the tokens alone.  A prompt or a decode position past
    the cache raises (JAX would crop or clamp it)."""
    cfg = tconfigs.get_config("internvl2-2b", smoke=True)
    params = ttransformer.init(torch.Generator().manual_seed(3), cfg, "cpu")
    assert tuple(params["patch_proj"].shape) == (cfg.d_model, cfg.d_model)
    tok = torch.randint(0, cfg.vocab, (1, 5),
                        generator=torch.Generator().manual_seed(4))
    pe = torch.randn((1, cfg.n_frontend_tokens, cfg.d_model),
                     generator=torch.Generator().manual_seed(5))
    _, cache = ttransformer.prefill(params, cfg,
                                    {"tokens": tok, "patch_embeds": pe}, 16)
    assert cache["pos"] == cfg.n_frontend_tokens + 5
    for _ in range(16 - cache["pos"]):
        _, cache = ttransformer.decode_step(params, cfg, cache, tok[:, 0])
    with pytest.raises(ValueError, match="past the 16-slot cache"):
        ttransformer.decode_step(params, cfg, cache, tok[:, 0])
    x, n_front = ttransformer._embed_inputs(params, cfg, {"tokens": tok})
    assert n_front == 0 and x.shape[1] == 5
    with pytest.raises(ValueError, match="exceeds"):
        ttransformer.prefill(params, cfg, {"tokens": tok, "patch_embeds": pe},
                             cfg.n_frontend_tokens + 4)


def test_state_tamper_goes_undetected_in_both_packages(case):
    """The sealed decode state (the RWKV and SSM state, the fixed-slot KV
    cache) is CTR-sealed without tags, in the reference as in the port:
    one flipped ciphertext bit decrypts to a changed state and the next
    decode's logits stay finite, equal in both packages within 1e-4 and
    different from the untampered step's."""
    cfg, jcfg = case["tcfg"], case["jcfg"]
    want = case["ref"][True]
    field = {"rwkv": "wkv", "hybrid": "ssm"}.get(cfg.family, "k_ct")
    state = dict(want["prefill_state"])
    bits = np.array(state[field])
    bits.reshape(-1)[3] ^= 1 << 20
    state[field] = bits
    tok = want["tokens"][0]
    jl, _ = jregistry.get_model(jcfg).decode_step(
        case["jparams"], jcfg, jax.tree_util.tree_map(jnp.asarray, state),
        jnp.asarray(tok), seal_ctx=(jnp.asarray(KEY_WORDS), NONCE))
    tl, _ = tregistry.get_model(cfg).decode_step(
        case["tparams"], cfg, port_state(state), torch.tensor(tok).long(),
        seal_ctx=(case["tkey"], NONCE))
    assert np.isfinite(np.asarray(jl)).all() and torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert not np.array_equal(np.asarray(jl), want["logits"][0])
