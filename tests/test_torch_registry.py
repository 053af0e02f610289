"""The port's model registry and the fixed-slot ServeEngine over every
ported family, against the JAX reference on the SMOKE configs.

``make_decode_state`` gives the reference's shapes and dtypes (ciphertext
dtypes when sealed) for every family.  Greedy generation of the port's
sealed ``ServeEngine`` equals the reference engine's on the same weights,
prompts and patch or frame embeddings.
The reference engine runs without security: its sealed engine gives the
same tokens (sealing is exact), but its jitted unseal of the weight tree
takes 40-100 s per family to compile on the CPU; the sealed decode chain
itself is held against the reference's in test_torch_families.py.  One
flipped bit of a sealed weight leaf turns every lane's logits to NaN.
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
from repro.models import registry as jregistry  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import registers as tregs  # noqa: E402
from repro_torch.core import sealed as tsealed  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import encdec, moe, rwkv, ssm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCHS = ("rwkv6-3b", "zamba2-1.2b", "internvl2-2b", "qwen3-4b",
         "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
         "seamless-m4t-large-v2", "llama3-405b")
FAMILY_ARCH = {"dense": "qwen3-4b", "vlm": "internvl2-2b",
               "rwkv": "rwkv6-3b", "hybrid": "zamba2-1.2b",
               "moe": "moonshot-v1-16b-a3b",
               "encdec": "seamless-m4t-large-v2"}
KEY_WORDS = np.array([0x0BADF00D, 0xC0FFEE11], np.uint32)
KEY_BYTES = bytes(range(32))
B, S, N_NEW = 3, 9, 6
UINT_OF = {np.dtype(np.uint32): torch.int32, np.dtype(np.uint16): torch.int16,
           np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32}


def channel(side: str, security: bool):
    ch_mod, pol, regs = ((jchannel, jpolicy, jregs) if side == "jax"
                         else (tchannel, tpolicy, tregs))
    extra = {"device": "cpu"} if side == "torch" else {}
    cfg = pol.SecurityConfig() if security else pol.SecurityConfig.off()
    return ch_mod.SecureChannel(
        key_words=KEY_WORDS, key_bytes=KEY_BYTES, config=cfg,
        host_regs=regs.HostRegisterFile(key=KEY_BYTES),
        device_regs=regs.DeviceRegisterFile(key=KEY_BYTES),
        session_id=50, **extra)


def max_len(cfg) -> int:
    n_front = cfg.n_frontend_tokens if cfg.frontend == "patch" else 0
    return n_front + S + N_NEW + 2


def test_archs_and_families():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(tconfigs.ARCH_IDS) == set(ARCHS) | {"granite-3-2b",
                                                   "minitron-8b"}
    for arch in tconfigs.ARCH_IDS:
        for smoke in (False, True):
            want = jconfigs.get_config(arch, smoke=smoke)
            got = tconfigs.get_config(arch, smoke=smoke)
            for f in ("family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "d_ff", "vocab", "hd", "qk_norm",
                      "rope_theta", "frontend", "n_frontend_tokens",
                      "dtype", "param_dtype", "q_block", "sub_quadratic",
                      "moe_dispatch_shards", "moe_ep", "remat"):
                assert getattr(got, f) == getattr(want, f), (arch, f)
            for sub in ("ssm", "hybrid", "rwkv", "moe", "encdec"):
                assert (vars(getattr(got, sub))
                        == vars(getattr(want, sub))), (arch, sub)
        for name in ("train_microbatch", "opt_state_dtype", "skip_reason"):
            args = (arch, "long_500k") if name == "skip_reason" else (arch,)
            assert (getattr(tconfigs, name)(*args)
                    == getattr(jconfigs, name)(*args)), (arch, name)
        assert tconfigs.acc_dtype(arch) == getattr(
            jconfigs.arch_module(arch), "ACC_DTYPE", "float32")
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            want = jconfigs.input_specs(jconfigs.get_config(arch),
                                        jconfigs.SHAPES_BY_NAME[shape], 16)
            got = tconfigs.input_specs(tconfigs.get_config(arch),
                                       tconfigs.SHAPES_BY_NAME[shape], 16)
            assert {k: (tuple(v.shape), str(v.dtype))
                    for k, v in want.items()} == {
                k: (s, str(d).replace("torch.", ""))
                for k, (s, d) in got.items()}, (arch, shape)
    assert tregistry.get_model(tconfigs.get_config("rwkv6-3b")) is rwkv
    assert tregistry.get_model(tconfigs.get_config("zamba2-1.2b")) is ssm
    assert tregistry.get_model(
        tconfigs.get_config("internvl2-2b")) is transformer
    for arch in ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"):
        assert tregistry.get_model(tconfigs.get_config(arch)) is moe
    assert tregistry.get_model(
        tconfigs.get_config("seamless-m4t-large-v2")) is encdec
    with pytest.raises(ValueError, match="unknown model family"):
        tregistry.get_model(tconfigs.get_config("qwen3-4b").with_(
            family="diffusion"))


@pytest.mark.parametrize("sealed", [False, True], ids=["plain", "sealed"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_make_decode_state_matches_reference(family, sealed):
    arch = FAMILY_ARCH[family]
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    want = jregistry.make_decode_state(jcfg, 2, 24, src_len=5, sealed=sealed)
    got = tregistry.make_decode_state(tcfg, 2, 24, src_len=5, sealed=sealed,
                                      device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        if k in ("pos", "nonce"):
            assert got[k] == int(v) == 0
            continue
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == UINT_OF[np.dtype(v.dtype)], k
        assert not got[k].any(), k


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One architecture served by the reference's engine (security off)
    and the port's sealed engine: (tokens of each, the port's engine, its
    batch)."""
    arch = request.param
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    np_params = jax.tree_util.tree_map(
        np.asarray, jregistry.get_model(jcfg).init(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.RandomState(7)
    batch = {"tokens": rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.frontend == "patch":
        batch["patch_embeds"] = rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.frontend == "frame":
        batch["frame_embeds"] = rng.standard_normal(
            (B, S + 2, jcfg.d_model)).astype(np.float32)
    out, engines = {}, {}
    for side in ("jax", "torch"):
        ch = channel(side, security=side == "torch")
        if side == "jax":
            params = jax.tree_util.tree_map(jnp.asarray, np_params)
            eng = jengine.ServeEngine(cfg=jcfg, params=params, channel=ch,
                                      max_len=max_len(jcfg))
            out[side] = eng.generate({k: jnp.asarray(v)
                                      for k, v in batch.items()}, N_NEW)
        else:
            params = ch.upload_tree(tregistry.params_from_numpy(np_params,
                                                                "cpu"))
            eng = tengine.ServeEngine(cfg=tcfg, params=params, channel=ch,
                                      max_len=max_len(tcfg))
            out[side] = eng.generate(batch, N_NEW)
        engines[side] = eng
    return out, engines["torch"], batch


def test_sealed_generate_matches_reference_tokens(served):
    out, eng, _ = served
    assert out["torch"].shape == (B, N_NEW)
    np.testing.assert_array_equal(out["torch"], out["jax"])
    assert eng.channel.device_regs.last_nonce == N_NEW


def test_weight_tamper_poisons_every_lane(served):
    _, eng, batch = served
    leaf = tsealed.tree_leaves(eng.params)[0]
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, state = eng._prefill(eng.params, batch, 1)
    assert torch.isfinite(logits).all()
    leaf.ct.view(-1)[5] ^= 1 << 3
    try:
        bad, _ = eng._decode(eng.params, state, logits.argmax(-1))
        assert torch.isnan(bad).all()
        bad, _ = eng._prefill(eng.params, batch, 9)
        assert torch.isnan(bad).all()
    finally:
        leaf.ct.view(-1)[5] ^= 1 << 3
