"""Mamba-2's SSD scan by the kernels' chunked algorithm
(``kernels/ssd_scan/ref.py``: ``ssd_forward_chunked``,
``ssd_backward_chunked``, which the ops run on the CPU), on the CPU.

* Lengths 1, 63, 64, 65 and 200 (chunks of 64: inside one, exactly one,
  one past, several), B 2, a nonzero initial state and a gradient into the
  final state: in float64 against torch autograd through the per-token
  loop, and the custom op in float32 within the limits ``ref.py`` states.
* Runs of decays of exactly 0 (la -800 and -inf: exp gives 0) and exactly
  1 (la 0): outputs and gradients finite and equal to the loop's.
* ``ssm.m2_forward`` at zamba2-1.2b's SMOKE size with layer 0 of the
  reference's ``init`` carried across as numpy, one head's decays all 0
  and one's all 1: the forward within 1e-5 max|ref| + 1e-6 of the JAX
  package's, the VJP by ``jax.vjp`` against torch autograd within 1e-4 of
  each gradient's largest entry.
* The heads a block of the kernels walks: more than 64 blocks at batch 1;
  the dry run's tally of a call on meta tensors counts the checkpoints and
  scratch the card's call makes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

torch.set_num_threads(1)

EXACT = 1e-10      # float64: the chunked algorithm against autograd
LENGTHS = [1, 63, 64, 65, 200]


def within(got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= rtol * np.abs(want).max() + atol


def loop(la, x, b, c, h):
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(la[:, t, :, None, None]) * h
             + torch.einsum("bhp,bn->bhpn", x[:, t], b[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t]))
    return torch.stack(ys, 1), h


def inputs(rng, S, B=2, H=3, P=5, N=6):
    la = -np.log1p(np.exp(rng.standard_normal((B, S, H))))
    return [torch.from_numpy(x) for x in (
        la, rng.standard_normal((B, S, H, P)), rng.standard_normal((B, S, N)),
        rng.standard_normal((B, S, N)), rng.standard_normal((B, H, P, N)))]


def check_against_the_loop(ins, rng, loop_la=None):
    """The chunked forward and backward (float64) and the op (float32)
    against autograd through the loop (run on ``loop_la`` in place of la
    where given); everything finite."""
    loop_ins = ins if loop_la is None else [loop_la] + ins[1:]
    leaves = [t.clone().requires_grad_() for t in loop_ins]
    y, h = loop(*leaves)
    dy = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    dh = torch.from_numpy(rng.standard_normal(tuple(h.shape)))
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    y2, h2, ck, dec = ref.ssd_forward_chunked(*ins)
    B, S, H, P = ins[1].shape
    assert tuple(ck.shape) == (B, -(-S // 64), H, P, ins[2].shape[-1])
    # dec: the product of each chunk's decays (1 past the end)
    a = torch.nn.functional.pad(torch.exp(loop_ins[0]), (0, 0, 0, -S % 64),
                                value=1.0)
    assert within(dec, a.reshape(B, -1, 64, H).prod(2), EXACT)
    _, _, ck_loop = ref.ssd_forward_ref(*loop_ins, save=True)
    assert within(ck, ck_loop, EXACT)
    assert within(y2, y.detach(), EXACT) and within(h2, h.detach(), EXACT)
    mine = list(ref.ssd_backward_chunked(*ins[:4], ck, dy, dh))
    mine[2], mine[3] = mine[2].sum(2), mine[3].sum(2)     # per head -> all
    for g, w in zip(mine, want):
        assert torch.isfinite(g).all()
        assert within(g, w, EXACT)
    f32 = [t.float().requires_grad_() for t in ins]
    y3, h3 = ops.ssd_scan(*f32)
    assert torch.isfinite(y3).all()
    assert within(y3.detach(), y.detach(), ref.FWD_RTOL, ref.FWD_ATOL)
    assert within(h3.detach(), h.detach(), ref.FWD_RTOL, ref.FWD_ATOL)
    ((y3 * dy.float()).sum() + (h3 * dh.float()).sum()).backward()
    for leaf, w in zip(f32, want):
        assert torch.isfinite(leaf.grad).all()
        assert within(leaf.grad, w, ref.GRAD_RTOL)


@pytest.mark.parametrize("S", LENGTHS)
def test_chunked_scan_and_backward_match_autograd_of_the_loop(S):
    rng = np.random.RandomState(S)
    check_against_the_loop(inputs(rng, S), rng)


@pytest.mark.parametrize("S, zero", [(65, -800.0), (200, -800.0),
                                     (200, -np.inf)])
def test_chunked_scan_on_decays_of_zero_and_one(S, zero):
    """A run of decays of 0 (exp(la) is 0 in float64 and float32) across
    the first chunk boundary, a run of decays of 1, and one head whose
    decays are all 0.  For la -inf the loop runs on -800 (the same decays;
    its autograd would multiply 0 by inf)."""
    rng = np.random.RandomState(S + 1)
    ins = inputs(rng, S)
    la = ins[0]
    la[:, 50:70] = zero
    la[:, 20:30] = 0.0
    la[:, :, 1] = zero
    check_against_the_loop(ins, rng, torch.clamp(la, min=-800.0))


def _layer0():
    """Layer 0's Mamba-2 block of the reference's SMOKE init, as numpy,
    with head 0's decays all 0 (A_log 6: la = -dt e^6 <= -104 for dt >
    0.26) and head 1's all 1 (A_log -40: la rounds to -0)."""
    cfg = jconfigs.get_config("zamba2-1.2b", smoke=True)
    params = jax.tree_util.tree_map(np.asarray,
                                    jssm.init(jax.random.PRNGKey(0), cfg))
    p = {k: np.array(v[0]) for k, v in params["layers"]["m2"].items()}
    p["A_log"][0], p["A_log"][1] = 6.0, -40.0
    p["dt_bias"][0] = 2.0                 # dt >= softplus(2 - |raw|)
    return cfg, p


@pytest.mark.parametrize("S", LENGTHS)
def test_m2_forward_and_vjp_match_the_reference(S):
    jcfg, p = _layer0()
    tcfg = tconfigs.get_config("zamba2-1.2b", smoke=True)
    d_inner, H, hp, N = tssm._m2_dims(tcfg)
    rng = np.random.RandomState(S + 2)
    B = 2
    ins = [rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32),
           0.5 * rng.standard_normal((B, H, hp, N)).astype(np.float32),
           rng.standard_normal((B, jcfg.ssm.conv_width - 1,
                                d_inner + 2 * N)).astype(np.float32)]
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jout, vjp = jax.vjp(lambda pp, x, h, c: jssm.m2_forward(pp, jcfg, x, h,
                                                           c),
                        jp, *[jnp.asarray(x) for x in ins])
    cot = [rng.standard_normal(o.shape).astype(np.float32) for o in jout]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cot))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in p.items()}
    tin = [torch.from_numpy(x.copy()).requires_grad_() for x in ins]
    tout = tssm.m2_forward(tp, tcfg, *tin)
    for t, j in zip(tout, jout):
        assert torch.isfinite(t).all()
        assert within(t.detach().numpy(), j, ref.FWD_RTOL, ref.FWD_ATOL)
    torch.autograd.backward(list(tout), [torch.from_numpy(c) for c in cot])
    for name in p:
        g = tp[name].grad.numpy()
        assert np.isfinite(g).all(), name
        assert within(g, jgrads[0][name], ref.GRAD_RTOL), name
    for t, j in zip(tin, jgrads[1:]):
        assert within(t.grad.numpy(), j, ref.GRAD_RTOL)


@pytest.mark.parametrize("B, S, H, heads", [
    (1, 4096, 64, 8), (1, 2048, 64, 8), (1, 32768, 64, 8), (16, 4096, 64, 8),
    (1, 512, 64, 2), (8, 1, 64, 2), (1, 64, 64, 1), (1, 1, 64, 1),
    (2, 13, 3, 1)])
def test_heads_per_block_gives_every_multiprocessor_a_block(B, S, H, heads):
    """The heads a block of the chunk kernels walks on the H100's 132
    multiprocessors: the most of 8, 4, 2 whose grid (chunks, head groups,
    B) still has a block for each, else 1; more than 64 blocks at
    zamba2-1.2b's batch-1 prompts (H 64)."""
    assert ops.heads_per_block(B, S, H, 132) == heads
    blocks = -(-S // 64) * -(-H // heads) * B
    assert heads == 1 or blocks >= 132
    if S >= 2048:
        assert blocks > 64


def test_meta_calls_make_the_buffers_the_card_makes():
    """Under the dry run's ``Tally`` a call on meta tensors makes every
    buffer the card's call makes: a forward that keeps no checkpoints
    still makes them (the card's kernels write them as scratch) with the
    chunks' decays, and a backward makes the gradient of every chunk's end
    state beside its outputs."""
    from repro_torch.launch.dryrun import Tally
    B, S, H, P, N = 1, 4096, 64, 64, 64

    def m(*shape):
        return torch.empty(shape, device="meta")

    def nbytes(*ts):
        return sum(4 * t.numel() for t in ts)

    ins = (m(B, S, H), m(B, S, H, P), m(B, S, N), m(B, S, N), m(B, H, P, N))
    ck, dec = m(B, S // 64, H, P, N), m(B, S // 64, H)
    with Tally() as tally:
        y, h, none = ops.ssd_forward(*ins)
    assert none.numel() == 0
    assert tally.peak == nbytes(y, h, ck, dec)
    dy, dh = m(B, S, H, P), m(B, H, P, N)
    with Tally() as tally:
        grads = ops.ssd_backward(*ins[:4], ck, dy, dh)
    assert tally.peak == nbytes(*grads, ck, dec)
