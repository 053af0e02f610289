"""The port's fixed-slot ServeEngine and transformer serving path against the
JAX reference.

Weights come from the reference's ``init`` on the granite-3-2b smoke config
and cross to torch as numpy.  In float32 with TF32 off the greedy token
streams of both engines must be equal, sealed and with security off.  The
sealed cache is held bit for bit where the seal is the only computation:
the reference's plaintext cache sealed by the port's layer seal gives the
reference's ciphertext, every layer and padding row included, and the
ciphertext of rows neither side has written is equal.  Rows written from
computed K/V unseal to within 1e-4 of the reference's (the matmuls sum in
another order, so their low bits, and hence their ciphertext, may
differ).  At bf16 the
fused decode (the sealed flash-decode kernel's plain version here; the
Pallas kernel in interpret mode on the reference side) must give logits
within 0.2 of the reference's over two steps: the reference's own
fused-vs-plain tolerance (tests/test_models.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import channel as jchannel  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import registers as jregs  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core import cipher  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import registers as tregs  # noqa: E402
from repro_torch.kernels.sealed_attention import ops as tsa  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KEY_WORDS = np.array([0x0BADF00D, 0xC0FFEE11], np.uint32)
KEY_BYTES = bytes(range(32))
B, S, MAX_LEN, N_NEW = 3, 11, 24, 6


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.numpy().view({torch.int32: np.uint32,
                               torch.int16: np.uint16}[t.dtype])
    return np.asarray(t)


def channel(side: str, security: bool, session: int):
    ch_mod, pol, regs = ((jchannel, jpolicy, jregs) if side == "jax"
                         else (tchannel, tpolicy, tregs))
    extra = {"device": "cpu"} if side == "torch" else {}
    cfg = pol.SecurityConfig() if security else pol.SecurityConfig.off()
    return ch_mod.SecureChannel(
        key_words=KEY_WORDS, key_bytes=KEY_BYTES, config=cfg,
        host_regs=regs.HostRegisterFile(key=KEY_BYTES),
        device_regs=regs.DeviceRegisterFile(key=KEY_BYTES),
        session_id=session, **extra)


@pytest.fixture(scope="module")
def np_params():
    cfg = jconfigs.get_config("granite-3-2b", smoke=True)
    return jax.tree_util.tree_map(
        np.asarray, registry.get_model(cfg).init(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def prompts():
    return np.random.RandomState(5).randint(0, 512, (B, S)).astype(np.int32)


def engines(np_params, security: bool):
    out = {}
    for side, sid in (("jax", 50), ("torch", 50)):
        ch = channel(side, security, sid)
        if side == "jax":
            cfg = jconfigs.get_config("granite-3-2b", smoke=True)
            params = jax.tree_util.tree_map(jnp.asarray, np_params)
            eng_mod = jengine
        else:
            cfg = tconfigs.get_config("granite-3-2b", smoke=True)
            params = ttransformer.params_from_numpy(np_params, "cpu")
            eng_mod = tengine
        if security:
            params = ch.upload_tree(params)
        out[side] = eng_mod.ServeEngine(cfg=cfg, params=params, channel=ch,
                                        max_len=MAX_LEN)
    return out


@pytest.fixture(scope="module")
def sealed_engines(np_params):
    return engines(np_params, True)


def test_generate_matches_reference_sealed(sealed_engines, prompts):
    got = {side: e.generate({"tokens": prompts}, N_NEW)
           for side, e in sealed_engines.items()}
    assert got["torch"].shape == (B, N_NEW)
    np.testing.assert_array_equal(got["torch"], got["jax"])
    regs = [e.channel.device_regs.last_nonce for e in sealed_engines.values()]
    assert regs == [N_NEW, N_NEW]


def test_generate_matches_reference_security_off(np_params, prompts):
    eng = engines(np_params, False)
    got = {side: e.generate({"tokens": prompts}, N_NEW)
           for side, e in eng.items()}
    np.testing.assert_array_equal(got["torch"], got["jax"])
    assert [e.channel.device_regs.last_nonce for e in eng.values()] == [0, 0]


def unseal_cache(cache, key, nonce):
    """The port's plaintext of a sealed fixed-slot cache (its own unseal)."""
    out = []
    for name, sel in (("k_ct", 0), ("v_ct", 1)):
        out.append(torch.stack([
            cipher.unseal_bits(cache[name][l], key,
                               ttransformer._kv_nonces(nonce, l)[sel],
                               torch.float32)
            for l in range(cache[name].shape[0])]))
    return out


def test_prefill_seals_the_padded_cache_bit_for_bit(sealed_engines, np_params,
                                                    prompts):
    eng = sealed_engines
    nonce = 7
    jl, jc = eng["jax"]._prefill(eng["jax"].params,
                                 {"tokens": jnp.asarray(prompts)},
                                 jnp.uint32(nonce))
    tl, tc = eng["torch"]._prefill(eng["torch"].params,
                                   {"tokens": torch.from_numpy(prompts)},
                                   nonce)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert tc["pos"] == int(jc["pos"]) == S
    assert tc["nonce"] == int(jc["nonce"]) == nonce
    # the reference's plaintext cache through the port's seal: bit for bit
    jcfg = jconfigs.get_config("granite-3-2b", smoke=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    _, jplain = jtransformer.prefill(jparams, jcfg,
                                     {"tokens": jnp.asarray(prompts)}, MAX_LEN)
    kv_key = eng["torch"]._kv_key
    k_ct, v_ct = ttransformer.seal_layers(
        torch.from_numpy(np.array(jplain["k"])),
        torch.from_numpy(np.array(jplain["v"])), kv_key, nonce)
    for name, ct in (("k_ct", k_ct), ("v_ct", v_ct)):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        np.testing.assert_array_equal(to_np(ct), np.asarray(jc[name]))
        # padding rows (plaintext zeros) of the port's own prefill too
        np.testing.assert_array_equal(to_np(tc[name])[:, :, S:],
                                      np.asarray(jc[name])[:, :, S:])
    tk, tv = unseal_cache(tc, kv_key, nonce)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jplain["k"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jplain["v"]),
                               rtol=1e-4, atol=1e-4)


def test_decode_cache_write_back_matches_reference(sealed_engines, prompts):
    """Two sealed decode steps: logits and tokens agree, the two new slots
    unseal to the reference's K/V and no other row moved."""
    eng = sealed_engines
    jl, jc = eng["jax"]._prefill(eng["jax"].params,
                                 {"tokens": jnp.asarray(prompts)},
                                 jnp.uint32(3))
    tl, tc = eng["torch"]._prefill(eng["torch"].params,
                                   {"tokens": torch.from_numpy(prompts)}, 3)
    for _ in range(2):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = eng["jax"]._decode(eng["jax"].params, jc, jt)
        tl, tc = eng["torch"]._decode(eng["torch"].params, tc, tt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    assert tc["pos"] == int(jc["pos"]) == S + 2
    kv_key = eng["torch"]._kv_key
    tk, tv = unseal_cache(tc, kv_key, 3)
    jk, jv = unseal_cache({n: torch.from_numpy(
        np.asarray(jc[n]).view(np.int32).copy()) for n in ("k_ct", "v_ct")},
        kv_key, 3)
    np.testing.assert_allclose(tk.numpy(), jk.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), jv.numpy(), rtol=1e-4, atol=1e-4)
    for name in ("k_ct", "v_ct"):
        np.testing.assert_array_equal(to_np(tc[name])[:, :, S + 2:],
                                      np.asarray(jc[name])[:, :, S + 2:])


def test_weight_tamper_poisons_every_lane(np_params, prompts):
    eng = engines(np_params, True)["torch"]
    eng.params["embed"].ct[3, 1] ^= 4
    logits, _ = eng._prefill(eng.params, {"tokens": torch.from_numpy(prompts)},
                             1)
    assert torch.isnan(logits).all()


def test_fused_decode_matches_reference_fused(np_params):
    """bf16: the port's fused decode against the reference's fused decode
    (Pallas in interpret mode) and against its own plain decode."""
    jcfg = jconfigs.get_config("granite-3-2b", smoke=True).with_(
        dtype="bfloat16", param_dtype="bfloat16")
    tcfg = tconfigs.get_config("granite-3-2b", smoke=True).with_(
        dtype="bfloat16", param_dtype="bfloat16")
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                np_params)
    tp = ttransformer.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tok = np.random.RandomState(1).randint(0, 512, (2, 12)).astype(np.int32)
    jkey = jnp.asarray(KEY_WORDS)
    tkey = torch.from_numpy(KEY_WORDS.view(np.int32).copy())
    jlo, _ = jtransformer.prefill(jp, jcfg, {"tokens": jnp.asarray(tok)}, 16)
    _, jcs = jtransformer.prefill(jp, jcfg, {"tokens": jnp.asarray(tok)}, 16,
                                  seal_ctx=(jkey, jnp.uint32(1)))
    tlo, tcp = ttransformer.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                                    16)
    _, tcs = ttransformer.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                                  16, seal_ctx=(tkey, 1))
    jf = jcfg.with_(fused_sealed_attention=True)
    tf = tcfg.with_(fused_sealed_attention=True)
    nxt = np.asarray(jnp.argmax(jlo, -1)).astype(np.int64)
    before = tsa.sealed_decode_attention.launches
    for _ in range(2):
        jl, jcs = jtransformer.decode_step(jp, jf, jcs, jnp.asarray(nxt, jnp.int32),
                                           seal_ctx=(jkey, jnp.uint32(1)))
        tl, tcs = ttransformer.decode_step(tp, tf, tcs, torch.from_numpy(nxt),
                                           seal_ctx=(tkey, 1))
        tpl, tcp = ttransformer.decode_step(tp, tcfg, tcp,
                                            torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32), atol=0.2)
        np.testing.assert_allclose(tl.float().numpy(), tpl.float().numpy(),
                                   atol=0.2)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)
    # the CPU runs the kernel's plain version: no launch is counted
    assert tsa.sealed_decode_attention.launches == before
    for name in ("k_ct", "v_ct"):
        assert tuple(tcs[name].shape) == tuple(jcs[name].shape)


def test_fused_requires_bf16(np_params):
    cfg = tconfigs.get_config("granite-3-2b", smoke=True).with_(
        fused_sealed_attention=True)
    tp = ttransformer.params_from_numpy(np_params, "cpu")
    tkey = torch.from_numpy(KEY_WORDS.view(np.int32).copy())
    tok = torch.zeros((1, 4), dtype=torch.int64)
    _, cache = ttransformer.prefill(tp, cfg, {"tokens": tok}, 8,
                                    seal_ctx=(tkey, 1))
    with pytest.raises(ValueError, match="bf16"):
        ttransformer.decode_step(tp, cfg, cache, tok[:, 0],
                                 seal_ctx=(tkey, 1))
