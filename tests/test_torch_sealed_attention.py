"""Sealed decode attention of the port against the JAX reference.

The port's plain versions (the CPU path of the kernel wrapper, and the
master-key form that mirrors ``repro.kernels.sealed_attention.ref``) are
held against the JAX oracle and the Pallas kernel in interpret mode, on the
shapes and tamper cases of ``tests/test_kernels.py``.  Inputs are made with
numpy from a seed.  Outputs agree within ``ref.OUT_RTOL`` (two bf16 ulps)
and ``ref.OUT_ATOL``: every version takes the softmax in f32 and rounds to
bf16 once.  The same limit rejects a kernel that reads the rows past
t_valid up to its tile's end, or drops one valid row.  ``bad`` counts and
the sealed cache (ciphertext and tags) are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.sealed_attention import ops as jsa  # noqa: E402
from repro_torch.core import mac as tmac  # noqa: E402
from repro_torch.kernels.sealed_attention import ops as tsa  # noqa: E402
from repro_torch.kernels.sealed_attention import ref as tsa_ref  # noqa: E402

torch.set_num_threads(1)

KEY = np.array([0x12345678, 0x9ABCDEF0], np.uint32)


def bf16_pair(shape, seed):
    """The same bf16 values as a jax array and a torch tensor."""
    x = jnp.asarray(np.random.RandomState(seed).standard_normal(shape),
                    jnp.bfloat16)
    bits = np.asarray(x).view(np.uint16).view(np.int16).copy()
    return x, torch.from_numpy(bits).view(torch.bfloat16)


def t_of(a) -> torch.Tensor:
    """uint32/uint16 jax bits as the port's int32/int16 storage."""
    a = np.asarray(a)
    return torch.from_numpy(a.view({4: np.int32, 2: np.int16}[a.itemsize])
                            .copy())


def np_of(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view({torch.int32: np.uint32,
                           torch.int16: np.uint16}[t.dtype])


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def sealed_pair(B, T, K, G, hd, nk, nv, seed):
    q = bf16_pair((B, K, G, hd), seed)
    k = bf16_pair((B, T, K, hd), seed + 1)
    v = bf16_pair((B, T, K, hd), seed + 2)
    jkey, tkey = jnp.asarray(KEY), t_of(KEY)
    jc = jsa.seal_cache(k[0], v[0], jkey, jnp.uint32(nk), jnp.uint32(nv))
    tc = tsa.seal_cache(k[1], v[1], tkey, nk, nv)
    return q, jc, tc


def test_seal_cache_matches_reference_bit_for_bit():
    _, jc, tc = sealed_pair(2, 48, 3, 2, 64, 7, 8, seed=0)
    for j, t in zip(jc, tc):
        assert tuple(j.shape) == tuple(t.shape)
        np.testing.assert_array_equal(np.asarray(j), np_of(t))


@pytest.mark.parametrize("tv", [1, 500, 1024])
def test_sealed_attention_matches_reference(tv):
    B, T, K, G, hd = 1, 1024, 2, 2, 128
    q, jc, tc = sealed_pair(B, T, K, G, hd, 3, 4, seed=7)
    jkey, tkey = jnp.asarray(KEY), t_of(KEY)
    o_ref, b_ref = jsa.decode_attention(q[0], *jc, jkey, jnp.uint32(3),
                                        jnp.uint32(4), tv, backend="jnp")
    o_int, b_int = jsa.decode_attention(q[0], *jc, jkey, jnp.uint32(3),
                                        jnp.uint32(4), tv, bt=256,
                                        backend="interpret")
    launches = tsa.sealed_decode_attention.launches
    o_t, b_t = tsa.decode_attention(q[1], *tc, tkey, 3, 4, tv)
    assert tsa.sealed_decode_attention.launches == launches   # CPU: plain
    o_m, b_m = tsa_ref.sealed_decode_attention_ref(
        q[1], *tc, tkey, 3, 4, tmac.nonce_mac_key(tkey, 3), tv)
    assert o_t.dtype == torch.bfloat16 and tuple(o_t.shape) == (B, K, G, hd)
    for o in (o_ref, o_int):
        np.testing.assert_allclose(f32(o_t), f32(o), rtol=tsa_ref.OUT_RTOL,
                                   atol=tsa_ref.OUT_ATOL)
        np.testing.assert_allclose(f32(o_m), f32(o), rtol=tsa_ref.OUT_RTOL,
                                   atol=tsa_ref.OUT_ATOL)
    for b in (b_ref, b_int, b_m):
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b))
    assert int(b_t.sum()) == 0


@pytest.mark.parametrize("fault", ["unmasked tail", "dropped row"])
def test_limit_rejects_a_masking_fault(fault):
    """The output limit sees the faults a kernel's masking can make, at the
    card check's t_valid 700 (inside the kernel's 8-row group 696-703): the
    rows past t_valid read up to the group's end, or the last valid row
    left out."""
    B, T, K, G, hd, tv = 2, 1024, 2, 4, 64, 700
    q, _, tc = sealed_pair(B, T, K, G, hd, 5, 6, seed=21)
    tkey = t_of(KEY)
    wrong_tv = {"unmasked tail": -(-tv // tsa.chunk_rows(hd))
                * tsa.chunk_rows(hd), "dropped row": tv - 1}[fault]
    want, _ = tsa.decode_attention(q[1], *tc, tkey, 5, 6, tv, verify=False)
    wrong, _ = tsa.decode_attention(q[1], *tc, tkey, 5, 6, wrong_tv,
                                    verify=False)
    assert tsa_ref.out_excess(want, want) < 0
    assert tsa_ref.out_excess(wrong, want) > 0


@pytest.mark.parametrize("row, want", [(100, 1), (400, 0)])
@pytest.mark.parametrize("which", ["k", "v"])
def test_tamper_counts_only_valid_rows(row, want, which):
    """A flipped ciphertext bit at t < t_valid is one bad row at its (b, k);
    past t_valid it is never read."""
    B, T, K, G, hd, tv = 1, 512, 1, 2, 64, 300
    q, jc, tc = sealed_pair(B, T, K, G, hd, 1, 2, seed=10)
    j_kc, j_vc, j_kt, j_vt = jc
    t_kc, t_vc, t_kt, t_vt = (x.clone() for x in tc)
    if which == "k":
        j_kc = j_kc.at[0, row, 0, 5].add(1)
        t_kc[0, row, 0, 5] += 1
    else:
        j_vc = j_vc.at[0, row, 0, 5].add(1)
        t_vc[0, row, 0, 5] += 1
    jkey, tkey = jnp.asarray(KEY), t_of(KEY)
    _, b_int = jsa.decode_attention(q[0], j_kc, j_vc, j_kt, j_vt, jkey,
                                    jnp.uint32(1), jnp.uint32(2), tv, bt=128,
                                    backend="interpret")
    _, b_t = tsa.decode_attention(q[1], t_kc, t_vc, t_kt, t_vt, tkey, 1, 2,
                                  tv)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_int))
    assert int(b_t.sum()) == want


@pytest.mark.parametrize("T, tv", [(1000, 0), (1000, 777), (16, 16)])
def test_plain_versions_agree_at_any_length(T, tv):
    """The kernel-contract plain version equals the master-key one, for any
    T (the Pallas kernel needs T % 512 == 0) and t_valid = 0."""
    B, K, G, hd = 2, 2, 4, 64
    q, _, tc = sealed_pair(B, T, K, G, hd, 5, 6, seed=3)
    tkey = t_of(KEY)
    o_m, b_m = tsa_ref.sealed_decode_attention_ref(
        q[1], *tc, tkey, 5, 6, tmac.nonce_mac_key(tkey, 5), tv)
    o_t, b_t = tsa.decode_attention(q[1], *tc, tkey, 5, 6, tv)
    assert torch.equal(b_t, b_m)
    np.testing.assert_allclose(f32(o_t), f32(o_m), atol=1e-6)
    assert torch.isfinite(o_t.float()).all()
    if tv == 0:
        assert not o_t.float().abs().any()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 1, 1, 12), dtype=torch.bfloat16)
    ct = torch.zeros((1, 4, 1, 12), dtype=torch.int16)
    key = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        tsa.sealed_decode_attention(q, ct, ct, None, None, key, key, None, 4,
                                    verify=False)
    q = torch.zeros((1, 1, 1, 16), dtype=torch.bfloat16)
    ct = torch.zeros((1, 4, 1, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="k_tags"):
        tsa.sealed_decode_attention(q, ct, ct, None, None, key, key, None, 4)


@pytest.mark.parametrize("hd, rows", [(32, 16), (64, 8), (128, 4)])
def test_chunk_rows_is_a_warp_group(hd, rows):
    """A warp's group: lane l holds Threefry block l % (hd/4) of four rows,
    so 32 lanes cover 4 * 32 / (hd/4) rows."""
    assert tsa.chunk_rows(hd) == rows
    assert tsa.chunk_rows(hd) * (hd // 4) == tsa.ROWS_PER_LANE * 32


@pytest.mark.parametrize("B, K, tv, hd, slots", [
    (8, 8, 1015, 64, 528), (8, 8, 1015, 64, 396), (8, 8, 1, 64, 528),
    (8, 8, 9, 64, 528), (2, 2, 1000, 128, 528), (2, 2, 5, 128, 528),
    (2, 2, 0, 64, 528), (64, 8, 4096, 64, 396), (1, 1, 1024, 64, 528)])
def test_split_plan_covers_t_valid_in_one_wave(B, K, tv, hd, slots):
    """The split covers rows 0..t_valid-1 with whole groups and no empty
    block, gives each block's warps a group each where the rows allow, and
    keeps the grid within one wave of ``slots`` blocks when B K allows."""
    n_split, chunk = tsa.split_plan(B, K, tv, hd, slots)
    rows = tsa.chunk_rows(hd)
    assert n_split >= 1 and chunk % rows == 0
    assert n_split * chunk >= tv and (n_split - 1) * chunk < max(tv, 1)
    if B * K <= slots:
        assert B * K * n_split <= slots
    if tv >= tsa.WARPS * rows * n_split:
        assert chunk >= tsa.WARPS * rows


def test_split_plan_fills_the_fixed_phase_wave():
    """Granite's fixed decode phase (B 8, K 8, t_valid 1015, hd 64) on 132
    SMs of four blocks: 8 splits of 128 rows, 512 blocks of 528 slots."""
    assert tsa.split_plan(8, 8, 1015, 64, 4 * 132) == (8, 128)


def test_counters_are_kept_per_stream_and_grown(monkeypatch):
    """Launches on one stream take turns on one zeroed buffer, which grows
    with B * K; launches on another stream hold another."""
    monkeypatch.setattr(tsa, "_sync", {})
    dev = torch.device("cpu")
    small = tsa._counters(dev, 11, 4, False)
    assert small.numel() == 8 and not small.any()
    assert tsa._counters(dev, 11, 3, False) is small
    other = tsa._counters(dev, 22, 4, False)
    assert other.data_ptr() != small.data_ptr()
    big = tsa._counters(dev, 11, 64, False)
    assert big.numel() == 128 and not big.any()
    assert tsa._counters(dev, 11, 4, False) is big
    assert tsa._counters(dev, 22, 4, False) is other


@pytest.mark.parametrize("pairs", [1, 64])
def test_sync_buffer_is_not_made_during_a_capture(monkeypatch, pairs):
    """A launch captured into a CUDA graph zeroes counters of its own (the
    graph replays the zeroing), never a stream's buffer, and makes none."""
    monkeypatch.setattr(tsa, "_sync", {})
    dev = torch.device("cpu")
    held = tsa._counters(dev, 11, pairs, False)
    one = tsa._counters(dev, 11, pairs, True)
    two = tsa._counters(dev, 11, pairs, True)
    assert one.numel() == two.numel() == 2 * pairs
    assert not one.any() and not two.any()
    assert len({held.data_ptr(), one.data_ptr(), two.data_ptr()}) == 3
    assert list(tsa._sync) == [(dev, 11)]
