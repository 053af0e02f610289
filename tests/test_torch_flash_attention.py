"""The fused causal attention kernels (``csrc/flash_attention.cu``) against
their plain version (``kernels/flash_attention/ref.py``), on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device, and runs
on a machine with an NVIDIA Hopper card (the kernels build for sm_90a):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_flash_attention.py -q

Limits (the CPU tests' reasons, tests/test_torch_flash_attention_cpu.py):
the float32 output within 2^-16 max|v| of the plain version's, the bf16
output within 2^-8 of each value beyond that, each bf16 gradient within
2^-8 of its value plus 2^-14 of its largest entry.  The log-sum-exp within
1e-5 of its largest entry.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


# (B, S, T, K, G, hd, bases): bases None is every lane at 0
CASES = [
    pytest.param(1, 1000, 1000, 8, 4, 64, None, id="granite-G4-hd64-S1000"),
    pytest.param(2, 300, 300, 2, 1, 128, None, id="G1-hd128-S300"),
    pytest.param(1, 257, 257, 2, 6, 64, None, id="G6-hd64-S257"),
    pytest.param(1, 130, 130, 1, 16, 128, None, id="G16-hd128-S130"),
    pytest.param(4, 512, 2560, 8, 4, 64, [1536, 512, 0, 1024],
                 id="prefill-G4-hd64"),
    pytest.param(3, 100, 700, 2, 2, 128, [600, 0, 37], id="prefill-G2-hd128"),
]


def _bases(bases, B):
    if bases is None:
        return None
    return torch.tensor(bases[:B], dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("B, S, T, K, G, hd, bases", CASES)
def test_kernels_match_plain_version(gen, B, S, T, K, G, hd, bases):
    H = K * G
    q, k, v = randn(gen, B, S, H, hd), randn(gen, B, T, K, hd), \
        randn(gen, B, T, K, hd)
    dout = randn(gen, B, S, H, hd)
    base = _bases(bases, B)
    if bases is not None and 0 in bases:
        q[bases.index(0)] = 0      # the scheduler's idle lane
    f0, b0 = ops.flash_forward.launches, ops.flash_backward.launches
    o, o32, lse = ops.flash_forward(q, k, v, base)
    ro, r32, rl = ref.forward(q, k, v, base)
    torch.cuda.synchronize()
    vmax = v.float().abs().max().item()
    assert (o32 - r32).abs().max().item() <= 2 ** -16 * vmax
    assert ((o.float() - r32).abs()
            <= 2 ** -8 * r32.abs() + 2 ** -16 * vmax).all()
    assert (lse - rl).abs().max().item() <= 1e-5 * rl.abs().max().item()
    got = ops.flash_backward(q, k, v, base, o32, lse, dout)
    want = ref.backward(q, k, v, base, r32, rl, dout)
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16
        assert ((x.float() - w).abs() <= 2 ** -8 * w.abs()
                + 2 ** -14 * w.abs().max()).all()
    assert ops.flash_forward.launches == f0 + 1
    assert ops.flash_backward.launches == b0 + 1
    # two runs agree bit for bit (no atomics)
    again = ops.flash_forward(q, k, v, base)
    assert all(torch.equal(x, y) for x, y in zip((o, o32, lse), again))
    got2 = ops.flash_backward(q, k, v, base, o32, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(got, got2))


def test_gqa_attention_takes_the_kernel_by_shape(gen):
    q, k, v = randn(gen, 2, 64, 8, 64), randn(gen, 2, 64, 2, 64), \
        randn(gen, 2, 64, 2, 64)
    f0 = ops.flash_forward.launches
    out = layers.gqa_attention(q, k, v, causal=True)
    assert ops.flash_forward.launches == f0 + 1
    assert torch.equal(out, ops.flash_forward(q, k, v)[0])
    f1 = ops.flash_forward.launches
    # decode steps, cache-length masks, non-causal and float32 calls do not
    layers.gqa_attention(q[:, :1], k, v, causal=True)
    layers.gqa_attention(q[:, :1], k, v, causal=False,
                         t_valid=torch.tensor([30, 64], device="cuda"))
    layers.gqa_attention(q, k, v, causal=True, t_valid=40)
    layers.gqa_attention(q, k, v, causal=False)
    layers.gqa_attention(q.float(), k.float(), v.float())
    assert ops.flash_forward.launches == f1


def test_no_logit_tensor_on_the_fused_path(gen):
    """A forward and backward at granite's training layer (S 4096, 32 heads
    of 64) allocates less than the float32 logits of one block of 512
    queries that the chain writes (268 MB)."""
    B, S, K, G, hd = 1, 4096, 8, 4, 64
    q, k, v = (t.requires_grad_() for t in (
        randn(gen, B, S, K * G, hd), randn(gen, B, S, K, hd),
        randn(gen, B, S, K, hd)))
    dout = randn(gen, B, S, K * G, hd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.flash_attention(q, k, v).backward(dout)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
    assert grown < B * 512 * K * G * S * 4


def test_remat_dots_recomputes_the_kernel(gen):
    """Under remat "dots" selective checkpointing keeps the projections and
    recomputes the kernel: gradients equal a run without checkpoints."""
    q, k, v = randn(gen, 1, 300, 8, 64), randn(gen, 1, 300, 2, 64), \
        randn(gen, 1, 300, 2, 64)
    w = randn(gen, 64, 64)
    dout = randn(gen, 1, 300, 8, 64)

    def fn(q, k, v):
        qq = (q.reshape(-1, 64) @ w).reshape(q.shape)
        return layers.gqa_attention(qq, k, v, causal=True)

    grads = {}
    for remat in ("none", "full", "dots"):
        cfg = type("Cfg", (), {"remat": remat})()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        f0 = ops.flash_forward.launches
        transformer._maybe_remat(fn, cfg)(*leaves).backward(dout)
        assert ops.flash_forward.launches == f0 + (1 if remat == "none"
                                                   else 2)
        grads[remat] = [t.grad for t in leaves]
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b)
                   for a, b in zip(grads[remat], grads["none"]))
