"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device, and runs
on a machine with an NVIDIA Hopper card (the kernels build for sm_90a):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cipher, mac  # noqa: E402
from repro_torch.kernels.ctr_cipher import ops as ctr_ops  # noqa: E402
from repro_torch.kernels.ctr_cipher import ref as ctr_ref  # noqa: E402
from repro_torch.kernels.sealed_attention import ops as sa_ops  # noqa: E402
from repro_torch.kernels.sealed_attention import ref as sa_ref  # noqa: E402
from repro_torch.kernels.sealed_matmul import ops as smm_ops  # noqa: E402
from repro_torch.kernels.sealed_matmul import ref as smm_ref  # noqa: E402
from repro_torch.kernels.tree_mac import ops as mac_ops  # noqa: E402
from repro_torch.kernels.tree_mac import ref as mac_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def bits(gen, shape, dtype):
    x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device="cuda",
                      dtype=torch.int64)
    return x.to(dtype)


@pytest.mark.parametrize("n, r, e, dtype, rows", [
    (1, 256, 256, torch.int32, False), (3, 300, 200, torch.int32, True),
    (2, 7, 49155, torch.int16, False), (4, 320, 64, torch.int16, True),
    (1, 5, 9, torch.int16, True)])
def test_ctr_kernel_matches_plain_version(gen, n, r, e, dtype, rows):
    x = bits(gen, (n, r, e), dtype)
    tkeys = bits(gen, (n, 2), torch.int32)
    rw = bits(gen, (n, r), torch.int32) if rows else None
    before = ctr_ops.ctr_xor.launches
    out = ctr_ops.ctr_xor(x, tkeys, rw)
    torch.cuda.synchronize()
    assert ctr_ops.ctr_xor.launches == before + 1
    assert torch.equal(out, ctr_ref.ctr_xor_ref(x, tkeys, rw))


@pytest.mark.parametrize("n, r, e, dtype, cw", [
    (1, 256, 512, torch.int32, 128), (1, 4, 49155, torch.int16, 2),
    (8, 1, 163840, torch.int16, 128), (3, 5, 24, torch.int32, 3)])
def test_tree_mac_kernel_matches_plain_version(gen, n, r, e, dtype, cw):
    x = bits(gen, (n, r, e), dtype)
    keys = (bits(gen, (n, cw), torch.int64) & 0x7FFFFFFE).to(torch.int32)
    before = mac_ops.mac_tags.launches
    out = mac_ops.mac_tags(x, keys)
    torch.cuda.synchronize()
    assert mac_ops.mac_tags.launches == before + 1
    assert torch.equal(out, mac_ref.mac_tags_ref(x, keys, cw))
    assert np.all(out.cpu().numpy() >= 0)


def sealed_cache(gen, B, T, K, G, hd):
    """A bf16 query and a sealed bf16 KV cache, with the kernel's keys."""
    q = torch.randn((B, K, G, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, T, K, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, T, K, hd), generator=gen, device="cuda").bfloat16()
    master = bits(gen, (2,), torch.int32)
    k_ct, v_ct, k_tags, v_tags = sa_ops.seal_cache(k, v, master, 3, 4)
    key_k = cipher.derive_tensor_key(master, 3)
    key_v = cipher.derive_tensor_key(master, 4)
    mkeys = mac.mac_keys(mac.nonce_mac_key(master, 3), hd // 2)
    return q, [k_ct, v_ct, k_tags, v_tags, key_k, key_v, mkeys]


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("T, tv", [(16, 0), (16, 1), (16, 16), (1000, 0),
                                   (1000, 1), (1000, 1000), (1024, 0),
                                   (1024, 1), (1024, 1024)])
def test_sealed_attention_kernel_matches_plain_version(gen, T, tv, G, hd,
                                                       verify):
    """Output within ``ref.OUT_RTOL`` (two bf16 ulps) and ``ref.OUT_ATOL``
    of the plain version (both f32 softmax, one bf16 rounding); ``bad``
    exact."""
    q, args = sealed_cache(gen, 2, T, 2, G, hd)
    before = sa_ops.sealed_decode_attention.launches
    out, bad = sa_ops.sealed_decode_attention(q, *args, tv, verify=verify)
    torch.cuda.synchronize()
    assert sa_ops.sealed_decode_attention.launches == before + 1
    want, want_bad = sa_ref.sealed_decode_attention_words_ref(
        q, *args, tv, verify)
    assert torch.isfinite(out.float()).all()
    assert sa_ref.out_excess(out, want) <= 0
    assert torch.equal(bad, want_bad) and int(bad.sum()) == 0


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("row, want", [(699, 1), (700, 0), (999, 0)])
def test_sealed_attention_kernel_counts_tamper_only_below_t_valid(
        gen, row, want, which):
    q, args = sealed_cache(gen, 2, 1000, 2, 4, 64)
    args[which][1, row, 1, 7] ^= 1 << 4
    _, bad = sa_ops.sealed_decode_attention(q, *args, 700, verify=True)
    _, want_bad = sa_ref.sealed_decode_attention_words_ref(q, *args, 700,
                                                           True)
    assert torch.equal(bad, want_bad)
    expect = torch.zeros_like(bad)
    expect[1, 1] = want
    assert torch.equal(bad, expect)


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("B, T, K, G, hd, tv", [
    (8, 1024, 8, 4, 64, 9), (8, 1024, 8, 4, 64, 1015),
    (1, 1024, 1, 4, 128, 129), (2, 1024, 2, 1, 128, 5),
    (1, 300, 1, 4, 128, 300), (2, 1000, 2, 4, 32, 999),
    (2, 512, 2, 3, 64, 300)])
def test_sealed_attention_kernel_at_group_and_split_edges(gen, B, T, K, G, hd,
                                                          tv, verify):
    """t_valid one row past a warp's group (8 rows at hd 64, 4 at hd 128)
    and past a split's end, the fixed phase's t_valid 1015, and grids of
    fewer blocks than SMs at hd 128; the merge's scratch is left zero."""
    q, args = sealed_cache(gen, B, T, K, G, hd)
    out, bad = sa_ops.sealed_decode_attention(q, *args, tv, verify=verify)
    torch.cuda.synchronize()
    want, want_bad = sa_ref.sealed_decode_attention_words_ref(
        q, *args, tv, verify)
    assert torch.isfinite(out.float()).all()
    assert sa_ref.out_excess(out, want) <= 0
    assert torch.equal(bad, want_bad) and int(bad.sum()) == 0
    assert not sa_ops._sync_buffer(q.device, B * K).any()


def test_sealed_attention_kernel_refuses_other_head_dims(gen):
    """The CUDA kernel takes hd 32, 64 and 128; another head_dim the
    wrapper otherwise accepts raises before any launch."""
    q, args = sealed_cache(gen, 1, 16, 1, 4, 16)
    before = sa_ops.sealed_decode_attention.launches
    with pytest.raises(ValueError, match="head_dim 16"):
        sa_ops.sealed_decode_attention(q, *args, 8, verify=False)
    assert sa_ops.sealed_decode_attention.launches == before


def sealed_operands(gen, M, K, N):
    """bf16 A [M, K] and B [K, N] (granite-like scales), sealed for the
    sealed matmul, with the kernel's keys: (atol, [a_ct, b_ct, tags_a,
    tags_b, key_a, key_b, mkeys])."""
    a = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    b = (torch.randn((K, N), generator=gen, device="cuda")
         * K ** -0.5).bfloat16()
    master = bits(gen, (2,), torch.int32)
    a_ct, tags_a = smm_ops.seal_operand(a, master, 5, 128, mac_nonce=5)
    b_ct, tags_b = smm_ops.seal_operand(b, master, 6, 128, mac_nonce=5)
    atol = smm_ref.c_atol(K, a.float().abs().max().item(),
                          b.float().abs().max().item())
    return atol, [a_ct, b_ct, tags_a, tags_b,
                  cipher.derive_tensor_key(master, 5),
                  cipher.derive_tensor_key(master, 6),
                  mac.mac_keys(mac.nonce_mac_key(master, 5), 128)]


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("M, K, N", [
    (256, 256, 256), (512, 256, 768), (256, 2048, 512), (2048, 512, 256),
    (768, 1280, 2048), (2048, 2048, 2048),
    # grids the full 4 x 2 cluster does not divide (2 and 6 row blocks, 3
    # column blocks), and K = 256: four k-stages against a ring of three
    (256, 256, 2048), (768, 512, 768), (768, 256, 1536)])
def test_sealed_matmul_kernel_matches_plain_version(gen, M, K, N, verify):
    """C within two bf16 ulps (``ref.C_RTOL``) plus ``ref.c_atol``; ``bad``
    exact."""
    atol, args = sealed_operands(gen, M, K, N)
    before = smm_ops.sealed_matmul.launches
    c, bad = smm_ops.sealed_matmul(*args, verify=verify)
    torch.cuda.synchronize()
    assert smm_ops.sealed_matmul.launches == before + 1
    want, want_bad = smm_ref.sealed_matmul_ref(*args, verify)
    assert torch.equal(bad, want_bad) and not bad.any()
    assert smm_ref.c_excess(c, want, atol) <= 0


@pytest.mark.parametrize("which, row, col", [
    ("a", 17, 93), ("a", 700, 1000), ("b", 1000, 5), ("b", 3, 1535)])
def test_sealed_matmul_kernel_counts_tamper_per_tile(gen, which, row, col):
    """A flipped A bit counts once for every column tile of its row tile,
    a flipped B bit once for every row tile of its chunk column."""
    M, K, N = 768, 1024, 1536
    _, args = sealed_operands(gen, M, K, N)
    args[0 if which == "a" else 1][row, col] ^= 1 << 3
    _, bad = smm_ops.sealed_matmul(*args)
    _, want_bad = smm_ref.sealed_matmul_ref(*args)
    expect = torch.zeros_like(bad)
    if which == "a":
        expect[row // 256, :] = 1
    else:
        expect[:, col // 256] = 1
    assert torch.equal(bad, want_bad) and torch.equal(bad, expect)
