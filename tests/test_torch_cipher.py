"""The port's CTR cipher against the JAX reference, bit for bit.

Same numpy inputs go through ``repro.core.cipher`` and
``repro_torch.core.cipher`` (on the CPU, where the CTR wrapper runs its
plain torch version); the plain version is also held against the Pallas
kernel in interpret mode.  Unsigned words cross as numpy views of the
port's int32/int16 storage.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cipher as jc  # noqa: E402
from repro.kernels.ctr_cipher import ops as jctr  # noqa: E402
from repro.serve import kv_pager as jkv  # noqa: E402
from repro_torch.core import cipher as tc  # noqa: E402
from repro_torch.kernels.ctr_cipher import ops as tctr  # noqa: E402
from repro_torch.kernels.ctr_cipher import ref as tref  # noqa: E402
from repro_torch.serve import kv_pager as tkv  # noqa: E402

torch.set_num_threads(1)

KEY = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}


def to_t(a: np.ndarray) -> torch.Tensor:
    """Unsigned numpy words -> the port's signed storage, same bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(_SIGNED[a.dtype]).copy())


def to_np(t: torch.Tensor) -> np.ndarray:
    """The port's int32/int16 storage -> unsigned numpy view."""
    return t.numpy().view({torch.int32: np.uint32,
                           torch.int16: np.uint16}[t.dtype])


def jaxify(x: np.ndarray, dtype: str):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def torchify(x: np.ndarray, dtype: str):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def test_threefry_matches_reference():
    rng = np.random.RandomState(0)
    for _ in range(4):
        key = rng.randint(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        x0 = rng.randint(0, 2**32, 33, dtype=np.uint64).astype(np.uint32)
        x1 = rng.randint(0, 2**32, 33, dtype=np.uint64).astype(np.uint32)
        want = jc.threefry2x32(jnp.asarray(key), jnp.asarray(x0),
                               jnp.asarray(x1))
        got = tc.threefry2x32(to_t(key), to_t(x0), to_t(x1))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), to_np(g))


def test_derived_keys_match_reference():
    k = jnp.asarray(KEY)
    for domain in (0, 0xA11CE, jkv.KV_K_DOMAIN, 0xFFFFFFFF):
        np.testing.assert_array_equal(np.asarray(jc.derive_key(k, domain)),
                                      to_np(tc.derive_key(to_t(KEY), domain)))
    for nonce in (0, 7, 0x0A010003, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            np.asarray(jc.derive_tensor_key(k, np.uint32(nonce))),
            to_np(tc.derive_tensor_key(to_t(KEY), nonce)))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 301])
def test_keystream_and_xor_words_match_reference(n):
    nonce = 0x0B020011
    ids = np.arange(5, 5 + n, dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(jc.keystream_blocks(jnp.asarray(KEY), jnp.uint32(nonce),
                                       jnp.asarray(ids))),
        to_np(tc.keystream_blocks(to_t(KEY), nonce, to_t(ids))))
    np.testing.assert_array_equal(
        np.asarray(jc.keystream_words(jnp.asarray(KEY), jnp.uint32(nonce), n)),
        to_np(tc.keystream_words(to_t(KEY), nonce, n)))
    w = np.random.RandomState(n).randint(0, 2**32, n, dtype=np.uint64)
    w = w.astype(np.uint32)
    want = np.asarray(jc.xor_words(jnp.asarray(w), jnp.asarray(KEY),
                                   jnp.uint32(nonce)))
    got = tc.xor_words(to_t(w), to_t(KEY), nonce)
    np.testing.assert_array_equal(want, to_np(got))
    np.testing.assert_array_equal(
        to_np(tc.xor_words(got, to_t(KEY), nonce)), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encrypt_decrypt_and_packing_match_reference(dtype):
    x = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    jx, tx = jaxify(x, dtype), torchify(x, dtype)
    np.testing.assert_array_equal(np.asarray(jc.pack_words(jx)),
                                  to_np(tc.pack_words(tx)))
    ct = tc.encrypt(tx, to_t(KEY), 99)
    np.testing.assert_array_equal(
        np.asarray(jc.encrypt(jx, jnp.asarray(KEY), 99)), to_np(ct))
    assert torch.equal(tc.decrypt(ct, to_t(KEY), 99, (3, 5), tx.dtype), tx)
    assert tc.words_for((3, 5), tx.dtype) == jc.words_for((3, 5), jx.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(17,), (4, 8), (3, 5, 9), (2, 3, 7),
                                   (2, 49)])
def test_seal_unseal_bits_match_reference(shape, dtype):
    """Shaped sealing, including odd last dims of 16-bit elements (the
    last word of each row half used, low half first)."""
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    jx, tx = jaxify(x, dtype), torchify(x, dtype)
    nonce = 0x0C03002A
    want = np.asarray(jc.seal_bits(jx, jnp.asarray(KEY), np.uint32(nonce)))
    got = tc.seal_bits(tx, to_t(KEY), nonce)
    np.testing.assert_array_equal(want, to_np(got))
    assert got.dtype == tc.uint_dtype_for(tx.dtype)
    assert torch.equal(tc.unseal_bits(got, to_t(KEY), nonce, tx.dtype), tx)
    np.testing.assert_array_equal(
        np.asarray(jc.keystream_like(jnp.asarray(KEY), np.uint32(nonce),
                                     shape, jx.dtype)),
        to_np(tc.keystream_like(to_t(KEY), nonce, shape, tx.dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seal_bits_slice_with_slot_rows_matches_reference(dtype):
    L, ps, K, hd, slot = 3, 8, 2, 6, 5
    x = np.random.RandomState(2).randn(L, K, hd).astype(np.float32)
    jrows = jkv.slot_rows(L, ps, K, slot)
    trows = tkv.slot_rows(L, ps, K, slot)
    np.testing.assert_array_equal(np.asarray(jrows), to_np(trows))
    want = jc.seal_bits_slice(jaxify(x, dtype), jnp.asarray(KEY),
                              np.uint32(77), jrows)
    got = tc.seal_bits_slice(torchify(x, dtype), to_t(KEY), 77, trows)
    np.testing.assert_array_equal(np.asarray(want), to_np(got))
    np.testing.assert_array_equal(
        np.asarray(jc.keystream_for_rows(jnp.asarray(KEY), np.uint32(77),
                                         jrows, hd, jaxify(x, dtype).dtype)),
        to_np(tc.keystream_for_rows(to_t(KEY), 77, trows, hd,
                                    getattr(torch, dtype))))


def test_batched_seal_equals_one_item_at_a_time():
    """A [N, 2] key seals N stacked tensors, each under its own key+nonce."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, 3, 7).astype(np.float32)).bfloat16()
    keys = to_t(rng.randint(0, 2**32, (4, 2), dtype=np.uint64)
                .astype(np.uint32))
    nonces = torch.tensor([1, 2, 3, 0x7FFFFFF0], dtype=torch.int32)
    both = tc.seal_bits(x, keys, nonces)
    for i in range(4):
        assert torch.equal(both[i], tc.seal_bits(x[i], keys[i],
                                                 int(nonces[i])))


@pytest.mark.parametrize("shape", [(256, 256), (300, 200), (256, 768)])
def test_plain_ctr_matches_pallas_kernel(shape):
    rng = np.random.RandomState(shape[1])
    x = rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    tkey = np.array([0xDEADBEEF, 0x01234567], np.uint32)
    want = np.asarray(jctr.ctr_xor(jnp.asarray(x), jnp.asarray(tkey),
                                   backend="interpret"))
    got = tref.ctr_xor_ref(to_t(x)[None], to_t(tkey)[None])[0]
    np.testing.assert_array_equal(want, to_np(got))
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(tctr.ctr_xor(to_t(x)[None], to_t(tkey)[None])[0], got)


def test_ctr_wrapper_checks_its_operands():
    x = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tctr.ctr_xor(x, torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        tctr.ctr_xor(x.float(), torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        tctr.ctr_xor(x, torch.zeros((2, 2), dtype=torch.int32),
                     rows=torch.zeros((2, 4), dtype=torch.int32))
