"""The fused causal attention's plain version (``kernels/flash_attention/
ref.py``, the algorithm of ``csrc/flash_attention.cu``) and its dispatch,
on the CPU.

* Forward and dQ, dK, dV through autograd, held against the blocked
  float32 chain that ``gqa_attention`` runs for every other call
  (``_attend_block``) and against the JAX package's ``gqa_attention`` with
  ``jax.vjp``, all in float32 from the same bf16 inputs: one group (G 1)
  and four heads a group (G 4), head_dim 64 and 128, lengths off the key
  tile (64) and the kernels' query tiles, per-lane bases with T > S (the
  prefill chunk over a gathered cache) and an idle lane as the scheduler
  sends it (start 0, its query rows made of padding).
* The wrapper's bf16 output and gradients on the same inputs (the
  custom ops over the plain version, with their autograd rule), within
  one bf16 rounding of the float32 results.
* ``gqa_attention`` takes the fused path only for causal, bf16, S > 1
  calls without a cache-length mask, head_dim 64 or 128 and G <= 16: a
  decode step, a ``t_valid`` call, non-causal, float32 and other shapes
  never reach the wrapper.
* Selective checkpointing (remat "dots") recomputes the function and
  gives the gradients of a run without checkpoints.
* On the meta device (the dry run) ``gqa_attention`` takes the fused
  ops as the card does: outputs and saved tensors of the card's shapes,
  ``meta_launches`` counted and ``launches`` not, and the dry run's
  ``Tally`` counts the causal FLOPs of the forward and the backward.

Tolerances.  The split P = P_hi + P_lo carries P to 16 significant bits
(relative error <= 2^-17 an entry) and the tiles change the order of the
float32 sums: the float32 output lies within 2^-16 max|v| of the chain's
and the JAX package's (measured: 4.7e-6 at max|v| 4.7), each float32
gradient within 2^-14 of its largest entry (measured: 7.1e-6); a bf16
result adds its own rounding, 2^-9 of the value (2^-8 allowed).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

torch.set_num_threads(1)

FWD_ATOL = 2.0 ** -16    # times max|v|
GRAD_RTOL = 2.0 ** -14   # of each gradient's largest entry
BF16_RTOL = 2.0 ** -8    # one bf16 rounding, with room

# (B, S, T, K, G, hd, bases): bases None is training (every lane at 0)
CASES = [
    pytest.param(1, 100, 100, 2, 1, 64, None, id="G1-hd64-S100"),
    pytest.param(2, 70, 70, 2, 4, 64, None, id="G4-hd64-S70"),
    pytest.param(1, 150, 150, 1, 4, 128, None, id="G4-hd128-S150"),
    pytest.param(2, 45, 45, 3, 1, 128, None, id="G1-hd128-S45"),
    pytest.param(3, 40, 200, 2, 4, 64, [150, 37, 0],
                 id="G4-hd64-prefill-idle-lane"),
    pytest.param(2, 33, 170, 2, 1, 128, [120, 0],
                 id="G1-hd128-prefill-idle-lane"),
]


def _inputs(B, S, T, K, G, hd, bases, seed=0):
    rng = np.random.default_rng(seed)

    def bf(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).bfloat16()

    q, k, v, dout = bf(B, S, K * G, hd), bf(B, T, K, hd), bf(B, T, K, hd), \
        bf(B, S, K * G, hd)
    if bases is not None and bases[-1] == 0:
        # the scheduler's idle lane: start 0, rows of padding tokens
        q[-1] = 0
    return q, k, v, dout


def _close(got, want, atol):
    return (got - want).abs().max().item() <= atol


def _rel_close(got, want, rtol):
    return (got - want).abs().max().item() <= rtol * want.abs().max().item()


@pytest.mark.parametrize("B, S, T, K, G, hd, bases", CASES)
def test_plain_version_matches_chain_and_jax(B, S, T, K, G, hd, bases):
    q, k, v, dout = _inputs(B, S, T, K, G, hd, bases)
    base_t = None if bases is None else torch.tensor(bases,
                                                     dtype=torch.int32)
    o, o32, lse = ref.forward(q, k, v, base_t)
    gq, gk, gv = ref.backward(q, k, v, base_t, o32, lse, dout)
    atol = FWD_ATOL * v.float().abs().max().item()

    # the blocked float32 chain through autograd
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    bp = 0 if bases is None else torch.tensor(bases)
    chain = layers.gqa_attention(qf, kf, vf, causal=True, base_pos=bp)
    chain.backward(dout.float())
    assert _close(o32, chain.detach(), atol)
    for got, leaf in ((gq, qf), (gk, kf), (gv, vf)):
        assert _rel_close(got, leaf.grad, GRAD_RTOL)

    # the JAX package's attention and its VJP
    jb = 0 if bases is None else jnp.asarray(bases)
    jo, vjp = jax.vjp(
        lambda a, b, c: jlayers.gqa_attention(a, b, c, causal=True,
                                              base_pos=jb),
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(dout.float().numpy()))
    assert _close(o32, torch.from_numpy(np.array(jo)), atol)
    for got, want in zip((gq, gk, gv), jgrads):
        assert _rel_close(got, torch.from_numpy(np.array(want)), GRAD_RTOL)

    # log-sum-exp [B, H, S] of the masked logits
    H = K * G
    pos = ref.positions(B, S, base_t, q.device)
    logits = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float().repeat_interleave(G, dim=2)) * hd ** -0.5
    vis = torch.arange(T)[None, None, :] <= pos[:, :, None]
    want_lse = torch.where(vis[:, None], logits, -torch.inf).logsumexp(-1)
    assert lse.shape == (B, H, S)
    assert _close(lse, want_lse, 1e-5 * want_lse.abs().max().item())

    # the wrapper (the custom ops over the plain version): bf16 results
    # within one rounding of the float32 ones
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa_ops.flash_attention(qb, kb, vb, 0 if bases is None else
                                 torch.tensor(bases))
    out.backward(dout)
    assert out.dtype == torch.bfloat16
    assert ((out.float() - o32).abs()
            <= BF16_RTOL * o32.abs()).all()
    for got, want in ((qb.grad, gq), (kb.grad, gk), (vb.grad, gv)):
        assert got.dtype == torch.bfloat16
        assert ((got.float() - want).abs() <= BF16_RTOL * want.abs()).all()


def test_gqa_attention_dispatches_by_shape(monkeypatch):
    calls = []

    def spy(q, k, v, base_pos=0):
        calls.append(tuple(q.shape))
        base = fa_ops.lane_bases(base_pos, q.shape[0], q.device)
        return ref.forward(q, k, v, base)[0]

    # let the dispatch see these CPU tensors as the kernels' device
    monkeypatch.setattr(fa_ops, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(fa_ops, "flash_attention", spy)
    q, k, v, _ = _inputs(2, 40, 40, 2, 4, 64, None)

    out = layers.gqa_attention(q, k, v, causal=True)
    assert calls == [(2, 40, 8, 64)]
    want = layers._attend_block(q.float().reshape(2, 40, 2, 4, 64),
                                k.float(), v.float(), torch.arange(40),
                                torch.arange(40), True).reshape(out.shape)
    assert ((out.float() - want).abs() <= BF16_RTOL * want.abs()
            + FWD_ATOL * v.float().abs().max()).all()
    # the prefill chunk: per-lane bases over a longer cache
    layers.gqa_attention(q, torch.cat([k, k], 1), torch.cat([v, v], 1),
                         causal=True, base_pos=torch.tensor([40, 0]))
    assert len(calls) == 2

    # none of these reach the wrapper
    layers.gqa_attention(q[:, :1], k, v, causal=True)                 # decode
    layers.gqa_attention(q[:, :1], k, v, causal=False,
                         t_valid=torch.tensor([30, 40]))       # engine decode
    layers.gqa_attention(q, k, v, causal=True, t_valid=35)            # t_valid
    layers.gqa_attention(q, k, v, causal=False)                   # non-causal
    layers.gqa_attention(q.float(), k.float(), v.float())             # float32
    layers.gqa_attention(q[..., :32], k[..., :32], v[..., :32])       # hd 32
    layers.gqa_attention(torch.cat([q] * 5, 2), k[:, :, :1],
                         v[:, :, :1])                                 # G 40
    assert len(calls) == 2
    monkeypatch.undo()
    layers.gqa_attention(q, k, v, causal=True)       # CPU: the plain chain
    assert len(calls) == 2


def test_selective_checkpoint_recomputes_the_function():
    q, k, v, dout = _inputs(1, 70, 70, 2, 4, 64, None, seed=3)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, 64)).astype(np.float32)).bfloat16()

    def fn(q, k, v):
        # a product the "dots" policy keeps, then the attention
        qq = (q.reshape(-1, 64) @ w).reshape(q.shape)
        return fa_ops.flash_attention(qq, k, v)

    grads = {}
    for remat in ("none", "full", "dots"):
        cfg = type("Cfg", (), {"remat": remat})()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = transformer._maybe_remat(fn, cfg)(*leaves)
        out.backward(dout)
        grads[remat] = [t.grad for t in leaves]
    for remat in ("full", "dots"):
        for got, want in zip(grads[remat], grads["none"]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("B, S, T, bases", [
    pytest.param(2, 96, 96, None, id="train"),
    pytest.param(3, 40, 200, [150, 37, 0], id="prefill"),
])
def test_meta_path_follows_the_card(B, S, T, bases):
    from repro_torch.launch.dryrun import Tally

    K, G, hd = 2, 4, 64
    H = K * G

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    q, k, v = (meta(B, S, H, hd).requires_grad_(),
               meta(B, T, K, hd).requires_grad_(),
               meta(B, T, K, hd).requires_grad_())
    bp = 0 if bases is None else torch.tensor(bases, device="meta")
    f0, b0 = fa_ops.flash_forward.launches, fa_ops.flash_backward.launches
    mf0 = fa_ops.flash_forward.meta_launches
    mb0 = fa_ops.flash_backward.meta_launches
    with Tally() as tally:
        out = layers.gqa_attention(q, k, v, causal=True, base_pos=bp)
    fwd = tally.flops
    at_end = bases is not None
    assert fwd == fa_ops.forward_flops(B, S, T, H, hd, at_end) > 0
    assert out.shape == (B, S, H, hd) and out.dtype == torch.bfloat16
    with Tally() as tally:
        out.backward(torch.empty_like(out))
    assert tally.flops == fa_ops.backward_flops(B, S, T, H, hd, at_end)
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert fa_ops.flash_forward.meta_launches - mf0 == 1
    assert fa_ops.flash_backward.meta_launches - mb0 == 1
    assert (fa_ops.flash_forward.launches,
            fa_ops.flash_backward.launches) == (f0, b0)
    # training counts the pairs below the diagonal, S (S + 1) / 2 a head
    if bases is None:
        assert fwd == 4 * hd * H * B * S * (S + 1) // 2
    # without autograd the forward keeps nothing for a backward
    o, o32, lse = fa_ops.flash_forward(q.detach(), k.detach(), v.detach(),
                                       save=False)
    assert o.shape == q.shape and o32 is None and lse is None
    o, o32, lse = fa_ops.flash_forward(q.detach(), k.detach(), v.detach())
    assert o32.shape == q.shape and o32.dtype == torch.float32
    assert lse.shape == (B, H, S)
    # operands the kernels do not take raise on the meta device as on the
    # card
    with pytest.raises(ValueError):
        fa_ops.flash_forward(q.detach().float(), k.detach().float(),
                             v.detach().float())
