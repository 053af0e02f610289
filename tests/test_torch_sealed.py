"""Sealed tensors, trees and channels of the port against the JAX reference.

Both packages' channels are built from the same explicit key words, HMAC
key and session id (the session id is part of every nonce), so the smoke
model's weights seal to the same ciphertext, tags and nonces, leaf for leaf.
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
from repro.core import sealed as jsealed  # noqa: E402
from repro.models import registry  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import registers as tregs  # noqa: E402
from repro_torch.core import sealed as tsealed  # noqa: E402
from repro_torch.core import trust as ttrust  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

torch.set_num_threads(1)

KEY_WORDS = np.array([0x0BADF00D, 0xC0FFEE11], np.uint32)
KEY_BYTES = bytes(range(32))
SESSION = 42


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view({torch.int32: np.uint32,
                           torch.int16: np.uint16}[t.dtype])


def jax_channel():
    return jchannel.SecureChannel(
        key_words=KEY_WORDS, key_bytes=KEY_BYTES,
        config=jpolicy.SecurityConfig(),
        host_regs=jregs.HostRegisterFile(key=KEY_BYTES),
        device_regs=jregs.DeviceRegisterFile(key=KEY_BYTES),
        session_id=SESSION)


def torch_channel():
    return tchannel.SecureChannel(
        key_words=KEY_WORDS, key_bytes=KEY_BYTES,
        config=tpolicy.SecurityConfig(),
        host_regs=tregs.HostRegisterFile(key=KEY_BYTES),
        device_regs=tregs.DeviceRegisterFile(key=KEY_BYTES),
        session_id=SESSION, device="cpu")


@pytest.fixture(scope="module")
def smoke_params():
    cfg = jconfigs.get_config("granite-3-2b", smoke=True)
    params = registry.get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_map(np.asarray, params)


def test_upload_tree_matches_reference_leaf_for_leaf(smoke_params):
    jtree = jax_channel().upload_tree(
        jax.tree_util.tree_map(jnp.asarray, smoke_params))
    ttree = torch_channel().upload_tree(
        ttransformer.params_from_numpy(smoke_params, "cpu"))
    jleaves = jax.tree_util.tree_leaves(jtree, is_leaf=jsealed.is_sealed)
    tleaves = tsealed.tree_leaves(ttree)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(
                 jtree, is_leaf=jsealed.is_sealed)[0]]
    assert len(jleaves) == len(tleaves) == 12
    for path, j, t in zip(paths, jleaves, tleaves):
        assert int(j.nonce) == t.nonce, path
        np.testing.assert_array_equal(np.asarray(j.ct), to_np(t.ct),
                                      err_msg=path)
        np.testing.assert_array_equal(np.asarray(j.tags), to_np(t.tags),
                                      err_msg=path)


def test_unseal_tree_roundtrip_and_tamper(smoke_params):
    params = ttransformer.params_from_numpy(smoke_params, "cpu")
    ch = torch_channel()
    sealed = ch.upload_tree(params)
    plain, ok = tsealed.unseal_tree(sealed, ch.jkey)
    assert bool(ok)
    for a, b in zip(tsealed.tree_leaves(plain), tsealed.tree_leaves(params)):
        assert torch.equal(a, b)
    sealed["layers"]["attn"]["wq"].ct[1, 3, 5] ^= 1 << 4
    _, ok = tsealed.unseal_tree(sealed, ch.jkey)
    assert not bool(ok)


def test_seal_unseal_reseal_match_reference():
    x = np.random.RandomState(0).randn(3, 49).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    key = jnp.asarray(KEY_WORDS)
    tkey = torch.from_numpy(KEY_WORDS.view(np.int32).copy())
    for prot in ("TRUSTED", "CTR", "NONE"):
        jspec = jpolicy.SealedSpec(getattr(jpolicy.Protection, prot), 4)
        tspec = tpolicy.SealedSpec(getattr(tpolicy.Protection, prot), 4)
        js = jsealed.reseal(jsealed.seal(jx, key, 9, jspec), jx, key)
        ts = tsealed.reseal(tsealed.seal(tx, tkey, 9, tspec), tx, tkey)
        assert int(js.nonce) == ts.nonce == 10
        np.testing.assert_array_equal(np.asarray(js.ct), to_np(ts.ct))
        np.testing.assert_array_equal(np.asarray(js.tags), to_np(ts.tags))
        back, ok = tsealed.unseal(ts, tkey)
        assert bool(ok) and torch.equal(back, tx)


def test_upload_and_download_match_reference():
    x = np.random.RandomState(1).randn(4, 33).astype(np.float32)
    js = jax_channel().upload(jnp.asarray(x).astype(jnp.bfloat16))
    ch = torch_channel()
    ts = ch.upload(torch.from_numpy(x).bfloat16())
    assert int(js.nonce) == ts.nonce
    np.testing.assert_array_equal(np.asarray(js.ct), to_np(ts.ct))
    np.testing.assert_array_equal(np.asarray(js.tags), to_np(ts.tags))
    assert torch.equal(ch.download(ts), torch.from_numpy(x).bfloat16())
    ts.ct[2, 7] ^= 1
    with pytest.raises(ttrust.SecurityError):
        ch.download(ts)


def test_nonce_guards_match_reference():
    for mod in (jsealed, tsealed):
        g = mod.NonceSpanGuard(span=4)
        g.spend(3)
        with pytest.raises(mod.NonceLaneExhausted):
            g.spend()
        c = mod.ResealCounter(limit=2)
        c.note(2)
        assert c.exhausted and c.headroom()["remaining"] == 0


def test_channel_nonces_launch_and_poison():
    jch, tch = jax_channel(), torch_channel()
    for span in (1, 131, 18, 70000 - 69990):
        assert jch.fresh_nonce(span) == tch.fresh_nonce(span)
    assert tch.launch(lambda a: a + 1, {"op": "x"}, 1) == 2
    state, nonce, tag = tch.host_regs.write(op="y")
    tch.device_regs.commit(state, nonce, tag)
    with pytest.raises(tregs.ReplayError):
        tch.device_regs.commit(state, nonce, tag)
    out = tchannel.poison_unless(torch.tensor(False), {
        "f": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)})
    assert torch.isnan(out["f"]).all()
    assert (out["i"] == np.iinfo(np.int32).min).all()


def test_entry_points_choose_the_card_unless_asked_for_cpu():
    ch = tchannel.SecureChannel.establish(device="cpu")
    assert ch.jkey.device.type == "cpu"
    assert ch.jkey.dtype == torch.int32
    assert isinstance(ch.key_bytes, bytes)
    if torch.cuda.is_available():
        assert tchannel.SecureChannel.insecure().jkey.is_cuda
    else:
        with pytest.raises(RuntimeError):
            tchannel.SecureChannel.insecure()
    with pytest.raises(ttrust.SecurityError):
        tchannel.SecureChannel(key_words=KEY_WORDS, key_bytes=KEY_BYTES,
                               config=tpolicy.SecurityConfig(),
                               session_id=256, device="cpu")
