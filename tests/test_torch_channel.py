"""The channel operations of the serving host side against the reference:
key wrap, epoch floors, register floors, session rekey, tree refresh and
tree reseal.  Both channels are built from the same key words, HMAC key
and session id, so every nonce, wrap and ciphertext must be equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import channel as jchannel  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import registers as jregs  # noqa: E402
from repro.core import sealed as jsealed  # noqa: E402
from repro.core import trust as jtrust  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import registers as tregs  # noqa: E402
from repro_torch.core import sealed as tsealed  # noqa: E402
from repro_torch.core import trust as ttrust  # noqa: E402

KEY_WORDS = np.array([0x0BADF00D, 0xC0FFEE11], np.uint32)
KEY_BYTES = bytes(range(32))
SESSION = 42


def channels():
    j = jchannel.SecureChannel(
        key_words=KEY_WORDS, key_bytes=KEY_BYTES,
        config=jpolicy.SecurityConfig(),
        host_regs=jregs.HostRegisterFile(key=KEY_BYTES),
        device_regs=jregs.DeviceRegisterFile(key=KEY_BYTES),
        session_id=SESSION)
    t = tchannel.SecureChannel(
        key_words=KEY_WORDS, key_bytes=KEY_BYTES,
        config=tpolicy.SecurityConfig(),
        host_regs=tregs.HostRegisterFile(key=KEY_BYTES),
        device_regs=tregs.DeviceRegisterFile(key=KEY_BYTES),
        session_id=SESSION, device="cpu")
    return j, t


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view({torch.int32: np.uint32,
                           torch.int16: np.uint16}[t.dtype])


def trees():
    rng = np.random.RandomState(3)
    x = {"a": rng.randn(4, 40).astype(np.float32),
         "b": {"c": rng.randn(3, 2, 16).astype(np.float32)}}
    return ({"a": jnp.asarray(x["a"]), "b": {"c": jnp.asarray(x["b"]["c"])}},
            {"a": torch.from_numpy(x["a"]),
             "b": {"c": torch.from_numpy(x["b"]["c"])}})


def leaves_equal(jtree, ttree):
    jl = [x for x in _jleaves(jtree)]
    tl = tsealed.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert int(j.nonce) == t.nonce
        np.testing.assert_array_equal(np.asarray(j.ct), to_np(t.ct))
        np.testing.assert_array_equal(np.asarray(j.tags), to_np(t.tags))


def _jleaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jleaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("context", [b"prefix/3|tenant/alice", b""])
def test_key_wrap_matches_reference(context):
    wrap_key = bytes(range(100, 132))
    w = tchannel.wrap_key_words(KEY_WORDS, wrap_key, context)
    assert w == jchannel.wrap_key_words(KEY_WORDS, wrap_key, context)
    np.testing.assert_array_equal(
        tchannel.unwrap_key_words(w, wrap_key, context), KEY_WORDS)
    wrong = tchannel.unwrap_key_words(w, wrap_key, context + b"x")
    np.testing.assert_array_equal(
        wrong, jchannel.unwrap_key_words(w, wrap_key, context + b"x"))
    assert not np.array_equal(wrong, KEY_WORDS)


def test_epoch_register_floor_and_rekey_match_reference():
    j, t = channels()
    new_words = np.array([0x1234, 0x5678], np.uint32)
    new_bytes = bytes(range(50, 82))
    for ch in (j, t):
        ch.fresh_nonce(3)
        ch.advance_epoch(5)
        ch.advance_epoch(2)             # a lower floor changes nothing
        ch.restore_register_floor(17)
        ch.restore_register_floor(9)    # monotone
    assert (t.epoch, t.fresh_nonce()) == (j.epoch, j.fresh_nonce())
    assert t.host_regs.nonce == j.host_regs.nonce == 17
    assert t.device_regs.last_nonce == j.device_regs.last_nonce == 17
    j.rekey(new_words, new_bytes)
    t.rekey(new_words, new_bytes)
    assert t.epoch == j.epoch and t.fresh_nonce(2) == j.fresh_nonce(2)
    np.testing.assert_array_equal(to_np(t.jkey), np.asarray(j.jkey))
    assert t.device_regs.last_nonce == j.device_regs.last_nonce
    with pytest.raises(ttrust.SecurityError):
        t.advance_epoch(1 << 40)
    with pytest.raises(jtrust.SecurityError):
        j.advance_epoch(1 << 40)


def test_refresh_tree_matches_reference_and_refuses_tamper():
    j, t = channels()
    jx, tx = trees()
    js, ts = j.upload_tree(jx), t.upload_tree(tx)
    leaves_equal(js, ts)
    jr, tr = j.refresh_tree(js), t.refresh_tree(ts)
    leaves_equal(jr, tr)
    assert t.epoch == j.epoch
    back, ok = tsealed.unseal_tree(tr, t.jkey)
    assert bool(ok) and torch.equal(back["a"], tx["a"])
    tr["b"]["c"].ct[1, 0, 3] ^= 1
    with pytest.raises(ttrust.SecurityError):
        t.refresh_tree(tr)


def test_reseal_tree_matches_reference():
    j, t = channels()
    jx, tx = trees()
    js, ts = j.upload_tree(jx), t.upload_tree(tx)
    jn = {"a": jx["a"] * 2, "b": {"c": jx["b"]["c"] - 1}}
    tn = {"a": tx["a"] * 2, "b": {"c": tx["b"]["c"] - 1}}
    leaves_equal(jsealed.reseal_tree(js, jn, j.jkey),
                 tsealed.reseal_tree(ts, tn, t.jkey))
