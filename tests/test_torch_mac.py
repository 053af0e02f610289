"""The port's tree MAC against the JAX reference, bit for bit.

Tags are canonical Mersenne-31 residues, so any exact modular sum gives
the same words; these tests hold the port's plain version (the CPU path of
the tree-MAC wrapper) to the reference's jnp functions and to the Pallas
kernel in interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import mac as jm  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels.tree_mac import ops as jmac  # noqa: E402
from repro_torch.core import mac as tm  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.kernels.tree_mac import ops as tmac  # noqa: E402
from repro_torch.kernels.tree_mac import ref as tref  # noqa: E402

torch.set_num_threads(1)

KEY = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}


def to_t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(_SIGNED[a.dtype]).copy())


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view({torch.int32: np.uint32,
                           torch.int16: np.uint16}[t.dtype])


def words(shape, seed=0, dtype=np.uint32):
    hi = 2**32 if dtype == np.uint32 else 2**16
    r = np.random.RandomState(seed).randint(0, hi, shape, dtype=np.uint64)
    return r.astype(dtype)


def test_m31_helpers_match_reference():
    """fold32 / addmod / mulmod / canon on uint32 values, edge cases too."""
    edge = np.array([0, 1, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                     0xFFFFFFFF], np.uint32)
    a = np.concatenate([edge, words((500,), 11)])
    b = np.concatenate([edge[::-1], words((500,), 12)])
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = tcommon.u32(to_t(a)), tcommon.u32(to_t(b))
    for name in ("fold32", "canon"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jcommon, name)(ja)),
            getattr(tcommon, name)(ta).numpy().astype(np.uint32))
    for name in ("addmod", "mulmod"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jcommon, name)(ja, jb)),
            getattr(tcommon, name)(ta, tb).numpy().astype(np.uint32))


@pytest.mark.parametrize("n", [1, 64, 128, 300])
def test_mac_keys_match_reference(n):
    for domain in (0xA11CE, 0x4B5047):
        np.testing.assert_array_equal(
            np.asarray(jm.mac_keys(jnp.asarray(KEY), n, domain)),
            to_np(tm.mac_keys(to_t(KEY), n, domain)))


def test_chunk_and_combine_tags_match_reference():
    w = words((7, 16), 1)
    keys = jm.mac_keys(jnp.asarray(KEY), 16)
    tkeys = tm.mac_keys(to_t(KEY), 16)
    want = jm.chunk_tags(jnp.asarray(w), keys)
    got = tm.chunk_tags(to_t(w), tkeys)
    np.testing.assert_array_equal(np.asarray(want), to_np(got))
    # 7 tags in groups of 16 -> one zero-padded level
    assert int(jm.combine_tags(want, keys)) == int(
        to_np(tm.combine_tags(got, tkeys)[None])[0])
    many = words((40,), 2)
    root_j = jm.combine_tags(jnp.asarray(many), keys[:4])
    root_t = tm.combine_tags(to_t(many), tkeys[:4])
    assert int(root_j) == int(to_np(root_t[None])[0])


@pytest.mark.parametrize("n, cw", [(10, 64), (128, 128), (300, 64),
                                   (10240, 128)])
def test_tag_root_and_mac_tensor_words_match_reference(n, cw):
    """Flat streams are zero-padded to whole chunks; padding words count."""
    w = words((n,), n)
    jt, jr = jm.mac_tensor_words(jnp.asarray(w), jnp.asarray(KEY), cw)
    tt, tr = tm.mac_tensor_words(to_t(w), to_t(KEY), cw)
    np.testing.assert_array_equal(np.asarray(jt), to_np(tt))
    assert int(jr) == int(to_np(tr[None])[0])
    assert int(jm.tag_root(jnp.asarray(w), jnp.asarray(KEY), cw)) == int(
        to_np(tm.tag_root(to_t(w), to_t(KEY), cw)[None])[0])
    assert bool(tm.verify_tags(to_t(w), to_t(KEY), cw, tt).all())


@pytest.mark.parametrize("shape, dtype, cw", [
    ((4, 256), np.uint32, 64),          # power-of-two chunks
    ((2, 3, 512), np.uint32, 128),
    ((2, 30), np.uint32, 4),            # 30 words -> 10 chunks of 3
    ((3, 9), np.uint16, 2),             # odd 16-bit row: 5 words, cw 1
    ((2, 24), np.uint16, 5),            # 12 words -> 3 chunks of 4
    ((2, 49155), np.uint16, 512),       # granite's unembed row: cw 2
])
def test_block_tags_match_reference(shape, dtype, cw):
    ct = words(shape, 5, dtype)
    want = np.asarray(jm.block_tags(jnp.asarray(ct), jnp.asarray(KEY), cw))
    got = tm.block_tags(to_t(ct), to_t(KEY), cw)
    np.testing.assert_array_equal(want, to_np(got))
    assert bool(tm.verify_block_tags(to_t(ct), to_t(KEY), cw, got).all())


def test_unembed_row_chunks_two_words():
    """24,578 words = 2 x 12,289: the divisor rule lands on cw = 2."""
    ct = to_t(words((1, 49155), 6, np.uint16))
    assert tm.block_tags(ct, to_t(KEY), 512).shape == (1, 12289)


def test_tampered_word_fails_verification():
    ct = to_t(words((3, 64), 7))
    tags = tm.block_tags(ct, to_t(KEY), 16)
    bad = ct.clone()
    bad[1, 40] ^= 1 << 9
    ok = tm.verify_block_tags(bad, to_t(KEY), 16, tags)
    assert int((~ok).sum()) == 1 and not bool(ok[1, 2])


def test_batched_block_tags_equal_one_item_at_a_time():
    rng = np.random.RandomState(8)
    ct = to_t(words((3, 5, 40), 8, np.uint16))
    keys = to_t(rng.randint(0, 2**32, (3, 2), dtype=np.uint64)
                .astype(np.uint32))
    both = tm.block_tags(ct, keys, 4)
    for i in range(3):
        assert torch.equal(both[i], tm.block_tags(ct[i], keys[i], 4))


@pytest.mark.parametrize("cw", [64, 128, 256])
def test_plain_tree_mac_matches_pallas_kernel(cw):
    x = words((256, 512), cw)
    want = np.asarray(jmac.mac_tags(jnp.asarray(x), jnp.asarray(KEY), cw,
                                    backend="interpret"))
    keys = tm.mac_keys(to_t(KEY), cw)
    got = tref.mac_tags_ref(to_t(x)[None], keys[None], cw)[0]
    np.testing.assert_array_equal(want, to_np(got))
    assert torch.equal(tmac.mac_tags(to_t(x)[None], keys[None])[0], got)


def test_mac_wrapper_checks_its_operands():
    x = torch.zeros((1, 2, 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        tmac.mac_tags(x, torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        tmac.mac_tags(x, torch.zeros((2, 5), dtype=torch.int32))
