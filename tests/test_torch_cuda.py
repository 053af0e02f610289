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
from repro_torch.models import layers  # noqa: E402

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
    (8, 1, 163840, torch.int16, 128), (3, 5, 24, torch.int32, 3),
    # odd 16-bit widths: odd and even row counts, cw 2 and a prime word
    # count in chunks of 1 (and of 13 on the general path)
    (1, 5, 49155, torch.int16, 2), (2, 3, 49155, torch.int16, 2),
    (3, 7, 25, torch.int16, 1), (3, 7, 25, torch.int16, 13),
    (2, 9, 1535, torch.int16, 3), (2, 7, 79, torch.int16, 8),
    (1, 3, 69, torch.int16, 5), (1, 3, 69, torch.int16, 7),
    # wide chunks, and cw 256 on an odd width (general path)
    (1, 64, 8192, torch.int16, 512), (2, 6, 512, torch.int16, 256),
    (1, 5, 1023, torch.int16, 256), (3, 5, 128, torch.int32, 32),
    (2, 3, 256, torch.int16, 64), (2, 3, 200, torch.int32, 100),
    (2, 4, 47, torch.int16, 12), (1, 3, 120, torch.int32, 24),
    # several items whose rows leave a block, a warp or a group part-filled
    (5, 37, 66, torch.int16, 3), (3, 7, 96, torch.int32, 32),
    (4, 300, 4099, torch.int16, 2), (7, 3, 300, torch.int16, 50)])
def test_tree_mac_kernel_matches_plain_version(gen, n, r, e, dtype, cw):
    x = bits(gen, (n, r, e), dtype)
    keys = (bits(gen, (n, cw), torch.int64) & 0x7FFFFFFE).to(torch.int32)
    before = mac_ops.mac_tags.launches
    out = mac_ops.mac_tags(x, keys)
    torch.cuda.synchronize()
    assert mac_ops.mac_tags.launches == before + 1
    assert torch.equal(out, mac_ref.mac_tags_ref(x, keys, cw))
    assert np.all(out.cpu().numpy() >= 0)


@pytest.mark.parametrize("e, cw", [(49155, 2), (1023, 256), (512, 256)])
def test_tree_mac_kernel_reads_a_view_at_a_two_byte_offset(gen, e, cw):
    """A view that starts one 16-bit element into its storage: the wrapper
    realigns it to the kernel's 16-byte vectors."""
    flat = bits(gen, (3 * 5 * e + 1,), torch.int16)
    x = flat[1:].view(3, 5, e)
    assert x.data_ptr() % 16 == 2
    keys = (bits(gen, (3, cw), torch.int64) & 0x7FFFFFFE).to(torch.int32)
    assert torch.equal(mac_ops.mac_tags(x, keys),
                       mac_ref.mac_tags_ref(x, keys, cw))


@pytest.mark.parametrize("e, cw, row, col", [
    (49155, 2, 3, 49154), (49155, 2, 2, 0), (8192, 512, 5, 4000),
    (1023, 256, 1, 777), (25, 1, 6, 24), (79, 8, 4, 17)])
def test_tree_mac_kernel_flags_exactly_the_flipped_chunk(gen, e, cw, row,
                                                         col):
    """One flipped ciphertext bit changes the one tag of its chunk, also in
    the half-used last word of an odd-width row and in a row's first word."""
    x = bits(gen, (2, 7, e), torch.int16)
    keys = (bits(gen, (2, cw), torch.int64) & 0x7FFFFFFE).to(torch.int32)
    tags = mac_ops.mac_tags(x, keys)
    x[1, row, col] ^= 1 << 5
    moved = mac_ops.mac_tags(x, keys) != tags
    assert int(moved.sum()) == 1
    assert bool(moved[1, row, col // 2 // cw])


@pytest.mark.parametrize("n, r, e, dtype, cw", [
    (2, 3, 64, torch.int32, 8), (2, 3, 79, torch.int16, 8),
    (1, 4, 512, torch.int32, 512), (1, 4, 8192, torch.int16, 512),
    (2, 5, 49155, torch.int16, 2), (2, 3, 25, torch.int16, 1),
    (2, 3, 69, torch.int16, 7), (1, 3, 1023, torch.int16, 256),
    (2, 4, 47, torch.int16, 12)])
def test_tree_mac_kernel_at_extreme_words_and_keys(gen, n, r, e, dtype, cw):
    """Every word 0xFFFFFFFF (a half-used last word 0xFFFF) and every key
    p - 1: the largest products the lazy sums take, on every path."""
    x = torch.full((n, r, e), -1, dtype=dtype, device="cuda")
    keys = torch.full((n, cw), 2**31 - 2, dtype=torch.int32, device="cuda")
    assert torch.equal(mac_ops.mac_tags(x, keys),
                       mac_ref.mac_tags_ref(x, keys, cw))


# row widths and chunk widths of the weight leaves of qwen3-4b (2560, 9728),
# rwkv6-3b (8960, 160), internvl2-2b's odd-width unembed (92553),
# zamba2-1.2b (in_proj 8384, conv 4224, unembed 32000), moonshot's experts
# and shared expert (1408: general path) and seamless's unembed (256206,
# cw 3: small path): none of the chunk widths is a power of two
FAMILY_WIDTHS = [(92553, 77), (8384, 262), (9728, 304), (2560, 320),
                 (4224, 352), (8960, 448), (32000, 500), (160, 80),
                 (1408, 352), (256206, 3)]


@pytest.mark.parametrize("extreme", [False, True], ids=["random", "extreme"])
@pytest.mark.parametrize("e, cw", FAMILY_WIDTHS)
def test_tree_mac_kernel_at_the_families_widths(gen, e, cw, extreme):
    """bf16 rows of the new families' widths, at the chunk width the
    divisor-aligned rule gives at 512 words: random bits and keys, and
    all-ones words with keys p - 1."""
    words = -(-e // 2)
    assert words // mac.chunk_count(words, 512) == cw
    shape = (2, 5, e)
    if extreme:
        x = torch.full(shape, -1, dtype=torch.int16, device="cuda")
        keys = torch.full((2, cw), 2**31 - 2, dtype=torch.int32,
                          device="cuda")
    else:
        x = bits(gen, shape, torch.int16)
        keys = (bits(gen, (2, cw), torch.int64) & 0x7FFFFFFE).to(torch.int32)
    out = mac_ops.mac_tags(x, keys)
    torch.cuda.synchronize()
    assert torch.equal(out, mac_ref.mac_tags_ref(x, keys, cw))
    assert torch.equal(out[:, 2:], mac_ref.mac_tags_ref(x[:, 2:], keys, cw,
                                                        row0=2))


@pytest.mark.parametrize("n, r, e, dtype, cw, limit", [
    (2, 37, 1408, torch.int16, 352, 704 * 5 + 3),   # general, 5-row slabs
    (1, 29, 79, torch.int16, 8, 40 * 11),           # small, odd rows
    (3, 17, 128, torch.int32, 32, 128 * 6),         # wide
    (1, 19, 4099, torch.int16, 2, 2050 * 8 + 5)])   # small, cw 2
def test_tree_mac_kernel_tags_an_item_over_the_limit_in_row_slabs(
        gen, monkeypatch, n, r, e, dtype, cw, limit):
    """An item of more words than ``MAX_ITEM_WORDS`` (lowered here, so the
    slabs are small): one launch per slab of ``slab_rows`` rows and item,
    each slab starting 16-byte aligned, and the tags of the whole item
    bit-exact against the plain version."""
    monkeypatch.setattr(mac_ops, "MAX_ITEM_WORDS", limit)
    x = bits(gen, (n, r, e), dtype)
    keys = (bits(gen, (n, cw), torch.int64) & 0x7FFFFFFE).to(torch.int32)
    rows = mac_ops.slab_rows(r, e * x.element_size())
    assert rows < r and rows * e * x.element_size() % 16 == 0
    before = mac_ops.mac_tags.launches
    out = mac_ops.mac_tags(x, keys)
    torch.cuda.synchronize()
    assert mac_ops.mac_tags.launches == before + n * -(-r // rows)
    assert torch.equal(out, mac_ref.mac_tags_ref(x, keys, cw))


@pytest.mark.parametrize("e, dtype, cw", [
    (1408, torch.int16, 352), (79, torch.int16, 8), (128, torch.int32, 32)])
def test_tree_mac_kernel_positions_wrap_at_row0(gen, e, dtype, cw):
    """A slab at row0 whose chunk positions (row0 + r) n_chunks + c pass
    2^32: the kernel's uint32 positions wrap as the plain version's (and
    the reference's) do, on the general, small and wide paths."""
    x = bits(gen, (1, 6, e), dtype)
    keys = (bits(gen, (1, cw), torch.int64) & 0x7FFFFFFE).to(torch.int32)
    nc = -(-e * x.element_size() // 4) // cw
    row0 = 2**32 // nc - 3
    out = torch.empty((1, 6, nc), dtype=torch.int32, device="cuda")
    mac_ops._launch(x, keys, out, row0)
    torch.cuda.synchronize()
    assert torch.equal(out, mac_ref.mac_tags_ref(x, keys, cw, row0=row0))
    assert not torch.equal(out, mac_ref.mac_tags_ref(x, keys, cw))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b",
                                  "seamless-m4t-large-v2"])
def test_moe_and_encdec_smoke_sealed_on_the_card_match_the_cpu(gen, arch):
    """The SMOKE config served sealed through ServeEngine on the card and
    on the CPU (float32, TF32 off), same weights, prompts, frame
    embeddings and keys: the same greedy tokens, CTR and MAC launched."""
    from repro_torch import configs
    from repro_torch.core.channel import SecureChannel
    from repro_torch.core.policy import SecurityConfig
    from repro_torch.core.sealed import tree_leaves, tree_unflatten
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine

    cfg = configs.get_config(arch, smoke=True)
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(1),
                                          cfg, "cpu")
    rng = np.random.RandomState(2)
    batch = {"tokens": rng.randint(0, cfg.vocab, (3, 9)).astype(np.int32)}
    if cfg.frontend == "frame":
        batch["frame_embeds"] = rng.standard_normal(
            (3, 11, cfg.d_model)).astype(np.float32)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    outs = []
    try:
        for dev in ("cpu", "cuda"):
            ch = SecureChannel(key_words=np.array([7, 8], np.uint32),
                               key_bytes=bytes(range(32)),
                               config=SecurityConfig(protect_launch=False),
                               session_id=60, device=dev)
            p = tree_unflatten(params, [x.to(dev) for x in tree_leaves(params)])
            eng = ServeEngine(cfg=cfg, params=ch.upload_tree(p), channel=ch,
                              max_len=9 + 6 + 2)
            c0, m0 = ctr_ops.ctr_xor.launches, mac_ops.mac_tags.launches
            outs.append(eng.generate(batch, 6))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert ctr_ops.ctr_xor.launches > c0 and mac_ops.mac_tags.launches > m0
    np.testing.assert_array_equal(outs[0], outs[1])


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
    fewer blocks than SMs at hd 128; the stream's counters are left zero."""
    q, args = sealed_cache(gen, B, T, K, G, hd)
    out, bad = sa_ops.sealed_decode_attention(q, *args, tv, verify=verify)
    torch.cuda.synchronize()
    want, want_bad = sa_ref.sealed_decode_attention_words_ref(
        q, *args, tv, verify)
    assert torch.isfinite(out.float()).all()
    assert sa_ref.out_excess(out, want) <= 0
    assert torch.equal(bad, want_bad) and int(bad.sum()) == 0
    assert not sa_ops._counters(
        q.device, torch.cuda.current_stream().cuda_stream, B * K, False).any()


def two_sealed_caches(gen):
    """Two fixed-phase caches with different inputs, the second with one
    flipped K bit inside t_valid 1015: [(q, args), (q, args)]."""
    runs = []
    for tamper in (False, True):
        q, args = sealed_cache(gen, 8, 1024, 8, 4, 64)
        if tamper:
            args[0][3, 500, 5, 9] ^= 1 << 6
        runs.append((q, args))
    return runs


def check_outputs(run, outs, n_bad):
    """Every (out, bad) of outs, launched over run, equals the plain
    version, with n_bad bad rows."""
    q, args = run
    want, want_bad = sa_ref.sealed_decode_attention_words_ref(
        q, *args, 1015, True)
    assert int(want_bad.sum()) == n_bad
    for out, bad in outs:
        assert sa_ref.out_excess(out, want) <= 0
        assert torch.equal(bad, want_bad)


def test_sealed_attention_kernel_on_two_streams_at_once(gen):
    """Two launches with different inputs, one with a tampered row, run on
    two streams at once: each writes its own ``out`` and ``bad`` (each
    stream has its own counters), equal to the plain version."""
    torch.cuda.synchronize()
    runs = two_sealed_caches(gen)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(3):
        for s, (q, args) in zip(streams, runs):
            with torch.cuda.stream(s):
                outs.append(sa_ops.sealed_decode_attention(
                    q, *args, 1015, verify=True))
    torch.cuda.synchronize()
    check_outputs(runs[0], outs[0::2], 0)
    check_outputs(runs[1], outs[1::2], 1)
    for s in streams:
        assert not sa_ops._counters(runs[0][0].device, s.cuda_stream, 64,
                                    False).any()


def test_sealed_attention_graph_replay_beside_a_launch(gen):
    """A CUDA graph of launches over the tampered cache, captured on one
    stream and replayed on another, runs at once with launches over the
    clean cache on the capture stream: the graph's launches count in
    counters of their own, so no launch takes another's tickets."""
    runs = two_sealed_caches(gen)
    (q0, a0), (q1, a1) = runs
    capture, other = torch.cuda.Stream(), torch.cuda.Stream()
    capture.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(capture):
        sa_ops.sealed_decode_attention(q1, *a1, 1015, verify=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=capture):
        held = [sa_ops.sealed_decode_attention(q1, *a1, 1015, verify=True)
                for _ in range(3)]
    torch.cuda.synchronize()
    other.wait_stream(torch.cuda.current_stream())
    clean, replayed = [], []
    for _ in range(3):
        with torch.cuda.stream(other):
            graph.replay()
        with torch.cuda.stream(capture):
            for _ in range(3):
                clean.append(sa_ops.sealed_decode_attention(
                    q0, *a0, 1015, verify=True))
        torch.cuda.synchronize()
        replayed += [(out.clone(), bad.clone()) for out, bad in held]
    check_outputs(runs[0], clean, 0)
    check_outputs(runs[1], replayed, 1)


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


@pytest.mark.parametrize("T", [300, 4096])
def test_qk_logits_of_bf16_operands_match_the_exact_product(gen, T):
    """bf16 q and k on the tensor cores (TF32 holds bf16 exactly) against
    the exact products summed in float64: within the float32 sum's
    order, hd additions at 2^-22 of sum |q| |k| (f32's 2^-23 doubled for
    the tensor cores' accumulation); the f32-operand product with TF32 off
    lies within the same limit.  TF32 is left as it was."""
    before = torch.backends.cuda.matmul.allow_tf32
    q = torch.randn((1, 64, 8, 4, 64), generator=gen, device="cuda").bfloat16()
    k = torch.randn((1, T, 8, 64), generator=gen, device="cuda").bfloat16()
    got = layers.qk_logits(q, k)
    assert got.dtype == torch.float32
    assert torch.backends.cuda.matmul.allow_tf32 == before
    spec = "bqkgd,btkd->bqkgt"
    exact = torch.einsum(spec, q.double(), k.double())
    limit = 64 * 2.0**-22 * torch.einsum(spec, q.double().abs(),
                                         k.double().abs())
    assert ((got.double() - exact).abs() <= limit).all()
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        full = torch.einsum(spec, q.float(), k.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert ((full.double() - exact).abs() <= limit).all()


@pytest.mark.parametrize("shape", [(7,), (3, 5), (1024, 1408), (2, 3, 9)])
def test_byte_payloads_seal_on_the_card_as_on_the_cpu(gen, shape):
    """int8 payloads (the cross-pod hook's quantized gradients) ride in
    the 32-bit lattice, rows padded to whole words: the CTR kernel's
    ciphertext equals the plain version's, and unseals to the payload."""
    key = bits(gen, (2,), torch.int32)
    x = bits(gen, shape, torch.int32).to(torch.int8)
    before = ctr_ops.ctr_xor.launches
    ct = cipher.seal_bits(x, key, 0x80000001)
    torch.cuda.synchronize()
    assert ctr_ops.ctr_xor.launches == before + 1
    assert ct.dtype == torch.uint8 and ct.shape == x.shape
    assert torch.equal(ct.cpu(), cipher.seal_bits(x.cpu(), key.cpu(),
                                                  0x80000001))
    assert torch.equal(cipher.unseal_bits(ct, key, 0x80000001, torch.int8),
                       x)


def wkv6_operands(gen, B, S, H, hd=64):
    """RWKV-6 scan inputs at the model's scales: r, k, v ~ N(0, 1), the log
    decay lw = -exp(N(0, 1) - 3), u ~ 0.1 N(0, 1), a nonzero initial state,
    and the gradients dy, ds of y and of the final state."""
    def n(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    lw = -torch.exp(n(B, S, H, hd) - 3)
    return (n(B, S, H, hd), n(B, S, H, hd), n(B, S, H, hd), lw,
            0.1 * n(H, hd), n(B, H, hd, hd)), (n(B, S, H, hd),
                                               n(B, H, hd, hd))


def ssd_operands(gen, B, S, H, P, N):
    """Mamba-2 scan inputs: the log decay la = -softplus(N(0, 1)), dtx, B,
    C ~ N(0, 1), a nonzero initial state, and the gradients dy, dh."""
    def n(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    la = -torch.nn.functional.softplus(n(B, S, H))
    return (la, n(B, S, H, P), n(B, S, N), n(B, S, N), n(B, H, P, N)), (
        n(B, S, H, P), n(B, H, P, N))


def within(got, want, rtol, atol=0.0):
    return (got - want).abs().max().item() <= (
        rtol * want.abs().max().item() + atol)


def check_wkv6_kernels(ins, dy, ds):
    """The WKV-6 wrappers once each way (one launch each) against the plain
    per-token versions, within the stated limits, outputs finite."""
    from repro_torch.kernels.wkv6_scan import ops, ref
    f0, b0 = ops.wkv6_forward.launches, ops.wkv6_backward.launches
    got = ops.wkv6_forward(*ins, save=True)
    want = ref.wkv6_forward_ref(*ins, save=True)
    grads = ops.wkv6_backward(*ins[:5], want[2], dy, ds)
    torch.cuda.synchronize()
    assert (ops.wkv6_forward.launches, ops.wkv6_backward.launches) == (
        f0 + 1, b0 + 1)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert within(g, w, ref.FWD_RTOL, ref.FWD_ATOL)
    for g, w in zip(grads, ref.wkv6_backward_ref(*ins[:5], want[2], dy, ds)):
        assert torch.isfinite(g).all()
        assert within(g, w, ref.GRAD_RTOL)


# S 1, S off the checkpoint interval, one and two past a chunk of 64,
# several chunks, B 16 (rwkv6-3b's and zamba2-1.2b's TRAIN_MICROBATCH), one
# rwkv6-3b sequence of 4096 tokens
@pytest.mark.parametrize("B, S, H", [(1, 1, 2), (2, 13, 3), (1, 64, 40),
                                     (2, 65, 3), (1, 200, 4), (16, 37, 4),
                                     (1, 4096, 40)])
def test_wkv6_kernels_match_plain_version(gen, B, S, H):
    ins, (dy, ds) = wkv6_operands(gen, B, S, H)
    check_wkv6_kernels(ins, dy, ds)


def test_wkv6_kernels_on_strong_decays_and_decays_of_zero_and_one(gen):
    """rwkv6-3b's layer shape with 300 tokens of strong decays (log decay
    down to -20 a token, where a fold of the decay into r and k over a
    chunk overflows), a run of 40 tokens whose decay is exactly 0 (-200:
    exp underflows), one of 70 across a chunk boundary (-inf) and one of
    40 whose decay is 1 (0)."""
    ins, (dy, ds) = wkv6_operands(gen, 1, 4096, 40)
    lw = ins[3]
    lw[:, 500:800] = -20.0 * torch.rand(lw[:, 500:800].shape, generator=gen,
                                        device="cuda")
    lw[:, 1000:1040] = -200.0
    lw[:, 3000:3070] = -float("inf")
    lw[:, 2000:2040] = 0.0
    check_wkv6_kernels(ins, dy, ds)


def test_wkv6_kernels_repeat_bit_for_bit(gen):
    """Two runs on the same inputs at rwkv6-3b's layer shape give equal
    outputs and gradients (no atomics: every sum in a fixed order)."""
    from repro_torch.kernels.wkv6_scan import ops
    ins, (dy, ds) = wkv6_operands(gen, 1, 4096, 40)
    runs = []
    for _ in range(2):
        y, s, ck = ops.wkv6_forward(*ins, save=True)
        runs.append((y, s, ck, *ops.wkv6_backward(*ins[:5], ck, dy, ds)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B, S, H", [(1, 4096, 40), (3, 1, 40),
                                     (2, 65, 3)])
def test_scan_launchers_report_the_grids_they_used(gen, B, S, H):
    """Each wrapper's ``last_plan`` is the launcher's own report: three
    kernels a call, 256 threads, the chunk kernels over (chunks, H, B) for
    the WKV (chunks, head groups, B for the SSD) and the carry one thread
    a state entry."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.wkv6_scan import ops as wops
    ins, (dy, ds) = wkv6_operands(gen, B, S, H)
    _, _, ck = wops.wkv6_forward(*ins, save=True)
    wops.wkv6_backward(*ins[:5], ck, dy, ds)
    nch = -(-S // 64)
    carry = -(-B * H * 64 * 64 // 256)
    for wrapper, names in ((wops.wkv6_forward, wops.FORWARD_KERNELS),
                           (wops.wkv6_backward, wops.BACKWARD_KERNELS)):
        plan = wrapper.last_plan
        assert plan["kernels_per_call"] == 3 and plan["threads"] == 256
        assert plan["grids"] == {names[0]: [nch, H, B],
                                 names[1]: [carry, 1, 1],
                                 names[2]: [nch, H, B]}
    sins, (sdy, sdh) = ssd_operands(gen, B, S, H, 64, 64)
    _, _, sck = sops.ssd_forward(*sins, save=True)
    sops.ssd_backward(*sins[:4], sck, sdy, sdh)
    for wrapper, names in ((sops.ssd_forward, sops.FORWARD_KERNELS),
                           (sops.ssd_backward, sops.BACKWARD_KERNELS)):
        plan = wrapper.last_plan
        g = plan["heads_per_block"]
        assert plan["grids"] == {names[0]: [nch, -(-H // g), B],
                                 names[1]: [carry, 1, 1],
                                 names[2]: [nch, -(-H // g), B]}


@pytest.mark.parametrize("B, S, H, P, N", [
    (1, 1, 2, 64, 64), (2, 13, 3, 64, 64), (1, 64, 64, 64, 64),
    (16, 37, 4, 64, 64), (2, 21, 4, 16, 8), (1, 9, 3, 5, 33),
    (1, 4096, 64, 64, 64)])
def test_ssd_kernels_match_plain_version(gen, B, S, H, P, N):
    """zamba2-1.2b's head (p 64, N 64), its SMOKE head (p 16, N 8) and a
    ragged one."""
    from repro_torch.kernels.ssd_scan import ops, ref
    ins, (dy, dh) = ssd_operands(gen, B, S, H, P, N)
    f0, b0 = ops.ssd_forward.launches, ops.ssd_backward.launches
    got = ops.ssd_forward(*ins, save=True)
    want = ref.ssd_forward_ref(*ins, save=True)
    for g, w in zip(got, want):
        assert within(g, w, ref.FWD_RTOL, ref.FWD_ATOL)
    grads = ops.ssd_backward(*ins[:4], want[2], dy, dh)
    torch.cuda.synchronize()
    assert (ops.ssd_forward.launches, ops.ssd_backward.launches) == (
        f0 + 1, b0 + 1)
    for g, w in zip(grads, ref.ssd_backward_ref(*ins[:4], want[2], dy, dh)):
        assert within(g, w, ref.GRAD_RTOL)


def check_ssd_kernels(ins, dy, dh):
    """The SSD wrappers once each way (one launch each) against the plain
    per-token versions, within the stated limits, outputs finite."""
    from repro_torch.kernels.ssd_scan import ops, ref
    f0, b0 = ops.ssd_forward.launches, ops.ssd_backward.launches
    got = ops.ssd_forward(*ins, save=True)
    want = ref.ssd_forward_ref(*ins, save=True)
    grads = ops.ssd_backward(*ins[:4], want[2], dy, dh)
    torch.cuda.synchronize()
    assert (ops.ssd_forward.launches, ops.ssd_backward.launches) == (
        f0 + 1, b0 + 1)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert within(g, w, ref.FWD_RTOL, ref.FWD_ATOL)
    for g, w in zip(grads, ref.ssd_backward_ref(*ins[:4], want[2], dy, dh)):
        assert torch.isfinite(g).all()
        assert within(g, w, ref.GRAD_RTOL)


# zamba2-1.2b's SMOKE head (16 heads of p 16, N 8) at one token, one past
# a chunk of 64 and one past 64 chunks
@pytest.mark.parametrize("S", [1, 65, 4097])
def test_ssd_kernels_at_ragged_lengths(gen, S):
    ins, (dy, dh) = ssd_operands(gen, 2, S, 16, 16, 8)
    check_ssd_kernels(ins, dy, dh)


def test_ssd_kernels_on_decays_of_zero_and_one(gen):
    """zamba2-1.2b's layer shape with a run of 40 tokens whose decay is
    exactly 0 (la -200: exp underflows), one of 70 across a chunk boundary
    and one of 40 whose decay is 1 (la 0)."""
    ins, (dy, dh) = ssd_operands(gen, 1, 4096, 64, 64, 64)
    la = ins[0]
    la[:, 1000:1040] = -200.0
    la[:, 3000:3070] = -200.0
    la[:, 2000:2040] = 0.0
    check_ssd_kernels(ins, dy, dh)


def test_ssd_kernels_repeat_bit_for_bit(gen):
    """Two runs on the same inputs at zamba2-1.2b's layer shape give equal
    outputs and gradients (no atomics: every sum in a fixed order)."""
    from repro_torch.kernels.ssd_scan import ops
    ins, (dy, dh) = ssd_operands(gen, 1, 4096, 64, 64, 64)
    runs = []
    for _ in range(2):
        y, h, ck = ops.ssd_forward(*ins, save=True)
        runs.append((y, h, ck, *ops.ssd_backward(*ins[:4], ck, dy, dh)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_scans_autograd_on_the_card_launches_one_kernel_each_way(gen):
    """``wkv6_scan`` and ``ssd_scan`` under autograd: one forward and one
    backward launch each, gradients equal to the plain versions' run
    through the same custom ops on CPU copies."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.wkv6_scan import ops as wops
    for scan, fwd, bwd, (ins, (dy, ds)) in (
            (wops.wkv6_scan, wops.wkv6_forward, wops.wkv6_backward,
             wkv6_operands(gen, 2, 19, 3)),
            (sops.ssd_scan, sops.ssd_forward, sops.ssd_backward,
             ssd_operands(gen, 2, 19, 3, 64, 64))):
        cuda = [t.clone().requires_grad_() for t in ins]
        cpu = [t.cpu().requires_grad_() for t in ins]
        f0, b0 = fwd.launches, bwd.launches
        y, s = scan(*cuda)
        ((y * dy).sum() + (s * ds).sum()).backward()
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (f0 + 1, b0 + 1)
        y, s = scan(*cpu)
        ((y * dy.cpu()).sum() + (s * ds.cpu()).sum()).backward()
        for g, w in zip(cuda, cpu):
            assert within(g.grad.cpu(), w.grad, 1e-4)


def test_scans_refuse_what_the_kernels_do_not_take(gen):
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.wkv6_scan import ops as wops
    (r, k, v, w, u, s0), _ = wkv6_operands(gen, 1, 3, 2, hd=32)
    with pytest.raises(ValueError, match="head dim 64"):
        wops.wkv6_forward(r, k, v, w, u, s0)
    (a, x, b, c, h0), _ = ssd_operands(gen, 1, 3, 2, 128, 16)
    with pytest.raises(ValueError, match="up to 64"):
        sops.ssd_forward(a, x, b, c, h0)
