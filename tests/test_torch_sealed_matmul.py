"""The port's sealed matmul against the JAX package.

The same numpy inputs (made from a seed) go through
``repro.kernels.sealed_matmul`` and the port.  ``seal_operand``'s
ciphertext and tags agree bit for bit; the port's ``bad`` grid (the CPU
path of the kernel wrapper) equals the Pallas kernel's in interpret mode
exactly, clean and with one tampered A or B word, verifying or not; C is
within ``ref.C_RTOL`` (two bf16 ulps) plus ``ref.c_atol`` of it.  That
limit rejects a product that skips its last k-step or decrypts B one
counter row off.  At multi-tile shapes the JAX oracle (``backend="jnp"``)
counts a bad chunk once, where the Pallas kernel, and so the port, counts
it once per output tile that reads it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.sealed_matmul import kernel as jsmm_kernel  # noqa: E402
from repro.kernels.sealed_matmul import ops as jsmm  # noqa: E402
from repro.core import cipher as jcipher, mac as jmac  # noqa: E402
from repro_torch.core import cipher, mac  # noqa: E402
from repro_torch.kernels.ctr_cipher.ref import ctr_xor_ref  # noqa: E402
from repro_torch.kernels.sealed_matmul import ops as tsmm  # noqa: E402
from repro_torch.kernels.sealed_matmul import ref as tsmm_ref  # noqa: E402

torch.set_num_threads(1)

KEY = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
NA, NB = 10, 11
SHAPES = [(256, 256, 256), (256, 512, 256), (512, 256, 512)]


def bf16_pair(shape, seed):
    """The same bf16 values as a jax array and a torch tensor."""
    x = jnp.asarray(np.random.RandomState(seed).standard_normal(shape),
                    jnp.bfloat16)
    bits = np.asarray(x).view(np.uint16).view(np.int16).copy()
    return x, torch.from_numpy(bits).view(torch.bfloat16)


def t_of(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.view({4: np.int32, 2: np.int16}[a.itemsize])
                            .copy())


def np_of(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view({torch.int32: np.uint32,
                           torch.int16: np.uint16}[t.dtype])


def sealed_operands(M, K, N, seed=0):
    """A and B sealed by both packages: ((a_ct, ta, b_ct, tb) jax,
    (same) torch, (a, b) bf16 torch plaintext)."""
    a, b = bf16_pair((M, K), seed), bf16_pair((K, N), seed + 1)
    jkey, tkey = jnp.asarray(KEY), t_of(KEY)
    j = (*jsmm.seal_operand(a[0], jkey, jnp.uint32(NA), 128,
                            mac_nonce=jnp.uint32(NA)),
         *jsmm.seal_operand(b[0], jkey, jnp.uint32(NB), 128,
                            mac_nonce=jnp.uint32(NA)))
    t = (*tsmm.seal_operand(a[1], tkey, NA, 128, mac_nonce=NA),
         *tsmm.seal_operand(b[1], tkey, NB, 128, mac_nonce=NA))
    return j, t, (a[1], b[1])


def kernel_keys():
    tkey = t_of(KEY)
    return (cipher.derive_tensor_key(tkey, NA),
            cipher.derive_tensor_key(tkey, NB),
            mac.mac_keys(mac.nonce_mac_key(tkey, NA), 128))


def pallas(j, verify):
    """The Pallas kernel in interpret mode: (C, bad grid)."""
    jkey = jnp.asarray(KEY)
    key_a = jcipher.derive_tensor_key(jkey, jnp.uint32(NA))
    key_b = jcipher.derive_tensor_key(jkey, jnp.uint32(NB))
    mk = jmac.mac_keys(jsmm._mac_key(jkey, jnp.uint32(NA), 0xA11CE), 128,
                       0xA11CE)
    return jsmm_kernel.sealed_matmul(j[0], j[2], j[1], j[3], key_a, key_b,
                                     mk, verify=verify, interpret=True)


def atol_of(a, b):
    return tsmm_ref.c_atol(a.shape[1], a.float().abs().max().item(),
                           b.float().abs().max().item())


@pytest.mark.parametrize("mkn", SHAPES)
def test_seal_operand_matches_reference_bit_for_bit(mkn):
    j, t, _ = sealed_operands(*mkn, seed=3)
    for x, y in zip(j, t):
        assert tuple(x.shape) == tuple(y.shape)
        np.testing.assert_array_equal(np.asarray(x), np_of(y))


@pytest.mark.parametrize("case", ["clean", "verify off", "tampered A",
                                  "tampered B"])
@pytest.mark.parametrize("mkn", SHAPES)
def test_bad_grid_and_product_match_the_pallas_kernel(mkn, case):
    M, K, N = mkn
    j, t, (a, b) = sealed_operands(M, K, N)
    j, t = list(j), [x.clone() for x in t]
    if case == "tampered A":
        j[0] = j[0].at[17, 93].add(1)
        t[0][17, 93] += 1
    elif case == "tampered B":
        j[2] = j[2].at[K - 5, N - 3].add(1)
        t[2][K - 5, N - 3] += 1
    verify = case != "verify off"
    c_int, bad_int = pallas(j, verify)
    launches = tsmm.sealed_matmul.launches
    c, bad = tsmm.sealed_matmul(t[0], t[2], t[1], t[3], *kernel_keys(),
                                verify=verify)
    assert tsmm.sealed_matmul.launches == launches          # CPU: plain
    np.testing.assert_array_equal(bad.numpy(), np.asarray(bad_int))
    want_sum = {"tampered A": N // 256, "tampered B": M // 256}.get(case, 0)
    assert int(bad.sum()) == want_sum
    _, total = tsmm.matmul(t[0], t[2], t[1], t[3], t_of(KEY), NA, NB,
                           verify=verify)
    assert total.dtype == torch.int32 and int(total) == want_sum
    c_int = torch.from_numpy(np.asarray(c_int).view(np.int16).copy()).view(
        torch.bfloat16)
    assert c.dtype == torch.bfloat16 and tuple(c.shape) == (M, N)
    assert tsmm_ref.c_excess(c, c_int, atol_of(a, b)) <= 0


def test_jnp_oracle_counts_a_bad_chunk_once():
    """At (512, 256, 512) one tampered A word is read by the two column
    tiles of its row tile: the Pallas kernel and the port count 2, the JAX
    oracle 1 (a reference behaviour, not a port fault)."""
    j, t, _ = sealed_operands(512, 256, 512)
    bad_a_j = j[0].at[17, 93].add(1)
    bad_a_t = t[0].clone()
    bad_a_t[17, 93] += 1
    jkey = jnp.asarray(KEY)
    _, n_jnp = jsmm.matmul(bad_a_j, j[2], j[1], j[3], jkey, jnp.uint32(NA),
                           jnp.uint32(NB), backend="jnp")
    _, n_int = jsmm.matmul(bad_a_j, j[2], j[1], j[3], jkey, jnp.uint32(NA),
                           jnp.uint32(NB), backend="interpret")
    _, n_t = tsmm.matmul(bad_a_t, t[2], t[1], t[3], t_of(KEY), NA, NB)
    assert (int(n_jnp), int(n_int), int(n_t)) == (1, 2, 2)


@pytest.mark.parametrize("fault", ["last k-step skipped",
                                   "B keystream one row off"])
def test_limit_rejects_faulty_products(fault):
    M, K, N = 256, 512, 256
    _, t, (a, b) = sealed_operands(M, K, N, seed=5)
    key_a, key_b, mkeys = kernel_keys()
    want, _ = tsmm.sealed_matmul(t[0], t[2], t[1], t[3], key_a, key_b, mkeys)
    atol = atol_of(a, b)
    assert tsmm_ref.c_excess(want, want, atol) < 0
    exact = (a.float() @ b.float()).to(torch.bfloat16)
    assert tsmm_ref.c_excess(want, exact, atol) <= 0
    if fault == "last k-step skipped":
        wrong = (a[:, :K - 32].float() @ b[:K - 32].float()).to(torch.bfloat16)
    else:
        rows = (torch.arange(K, dtype=torch.int32) + 1)[None]
        bw = ctr_xor_ref(t[2][None], key_b[None], rows)[0].view(torch.bfloat16)
        wrong = (a.float() @ bw.float()).to(torch.bfloat16)
    assert tsmm_ref.c_excess(wrong, want, atol) > 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    key = torch.zeros((2,), dtype=torch.int32)
    ct = torch.zeros((256, 384), dtype=torch.int16)
    with pytest.raises(ValueError, match="multiples of 256"):
        tsmm.sealed_matmul(ct, ct.T.contiguous(), None, None, key, key, None,
                           verify=False)
    ct = torch.zeros((256, 256), dtype=torch.int16)
    with pytest.raises(ValueError, match="tags_a"):
        tsmm.sealed_matmul(ct, ct, None, None, key, key, None)
    with pytest.raises(AssertionError, match="bn == bk"):
        tsmm.matmul(ct, ct, None, None, key, 1, 2, bn=128)


@pytest.mark.parametrize("M, N, shape", [
    (8192, 8192, (4, 2)), (8192, 2048, (4, 2)), (256, 256, (2, 1)),
    (256, 2048, (2, 2)), (768, 768, (2, 1)), (512, 768, (4, 1)),
    (768, 512, (2, 2)), (768, 1536, (2, 2))])
def test_cluster_shape_is_the_largest_that_divides_the_grid(M, N, shape):
    """The kernel's clusters: the largest of 4, 2 along M (M/128 row
    blocks, even as M is a multiple of 256) and of 2, 1 along N (N/256
    column blocks) that divide the grid."""
    cm, cn = tsmm.cluster_shape(M, N)
    assert (cm, cn) == shape
    assert (M // tsmm.BLOCK_M) % cm == 0 and (N // tsmm.BLOCK_N) % cn == 0


@pytest.mark.parametrize("M, K, N, per_mkn", [
    (8192, 2048, 8192, 2 / 512), (8192, 8192, 2048, 2 / 512),
    (256, 256, 256, 1 / 256 + 1 / 256), (512, 256, 768, 1 / 256 + 1 / 512)])
def test_keystream_model_counts_one_regeneration_per_cluster(M, K, N,
                                                              per_mkn):
    """Every A tile is decrypted once per cluster column of the grid and
    every B tile once per cluster row: 18.5 M K N (1/(256 cn) + 1/(128 cm))
    integer operations, at granite's MLP products 9.9 G, below the 39.7 G
    of 128 x 128 tiles without clusters."""
    ops = tsmm.keystream_ops(M, K, N)
    assert ops == pytest.approx(18.5 * M * K * N * per_mkn)
    assert ops < 18.5 * M * K * N * 2 / 128
    if (M, K, N) == (8192, 2048, 8192):
        assert 9.9e9 < ops < 10.0e9
