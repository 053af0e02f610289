"""RWKV-6's WKV scan by the kernels' chunked algorithm
(``kernels/wkv6_scan/ref.py``: ``wkv6_forward_chunked``,
``wkv6_backward_chunked``, which the ops run on the CPU), on the CPU.

* Lengths 1, 15, 16, 17, 63, 64, 65 and 200 (sub-chunks of 16 and chunks
  of 64: inside one, exactly one, one past, several), B 2, a nonzero
  initial state and a gradient into the final state: in float64 against
  torch autograd through the per-token loop within 1e-10 of each output's
  largest entry, and the custom op in float32 within the limits ``ref.py``
  states (outputs FWD_RTOL of their largest entry + FWD_ATOL, gradients
  GRAD_RTOL of theirs).
* Runs of decays of exactly 0 (lw -800 and -inf: exp gives 0) and exactly
  1 (lw 0), and strong decays (lw down to -20 a token, where folding the
  decay into r and k over a chunk overflows): outputs and gradients finite
  and within the same limits of the loop's.
* ``rwkv.time_mix`` at rwkv6-3b's SMOKE size with layer 0 of the
  reference's ``init`` carried across as numpy, one head's decays all 0 and
  the other's all 1, or every decay strong: the forward within 1e-5
  max|ref| + 1e-6 of the JAX package's, the VJP by ``jax.vjp`` against
  torch autograd within 1e-4 of each gradient's largest entry.
* The dry run's tally of a call on meta tensors counts the checkpoints,
  scratch and du partials the card's call makes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.wkv6_scan import ops, ref  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402

torch.set_num_threads(1)

EXACT = 1e-10      # float64: the chunked algorithm against autograd
LENGTHS = [1, 15, 16, 17, 63, 64, 65, 200]


def within(got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= rtol * np.abs(want).max() + atol


def loop(r, k, v, lw, u, s):
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = torch.exp(lw[:, t])[..., None] * s + kv
    return torch.stack(ys, 1), s


def inputs(rng, S, B=2, H=3, hd=5):
    lw = -np.exp(rng.standard_normal((B, S, H, hd)) - 1)
    return [torch.from_numpy(x) for x in (
        rng.standard_normal((B, S, H, hd)), rng.standard_normal((B, S, H, hd)),
        rng.standard_normal((B, S, H, hd)), lw,
        0.3 * rng.standard_normal((H, hd)),
        rng.standard_normal((B, H, hd, hd)))]


def check_against_the_loop(ins, rng, loop_lw=None):
    """The chunked forward and backward (float64) and the op (float32)
    against autograd through the loop (run on ``loop_lw`` in place of lw
    where given); everything finite."""
    loop_ins = ins if loop_lw is None else ins[:3] + [loop_lw] + ins[4:]
    leaves = [t.clone().requires_grad_() for t in loop_ins]
    y, s = loop(*leaves)
    dy = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    ds = torch.from_numpy(rng.standard_normal(tuple(s.shape)))
    want = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
    y2, s2, ck, dec = ref.wkv6_forward_chunked(*ins)
    B, S, H, hd = ins[0].shape
    assert tuple(ck.shape) == (B, -(-S // 64), H, hd, hd)
    # dec: the product of each chunk's decays, a channel (1 past the end)
    w = torch.nn.functional.pad(torch.exp(loop_ins[3]),
                                (0, 0, 0, 0, 0, -S % 64), value=1.0)
    assert within(dec, w.reshape(B, -1, 64, H, hd).prod(2), EXACT)
    _, _, ck_loop = ref.wkv6_forward_ref(*loop_ins, save=True)
    assert within(ck, ck_loop, EXACT)
    assert within(y2, y.detach(), EXACT) and within(s2, s.detach(), EXACT)
    mine = list(ref.wkv6_backward_chunked(*ins[:5], ck, dy, ds))
    assert tuple(mine[4].shape) == (B, -(-S // 64), H, hd)
    mine[4] = mine[4].sum((0, 1))                 # partials a chunk -> du
    for g, wg in zip(mine, want):
        assert torch.isfinite(g).all()
        assert within(g, wg, EXACT)
    f32 = [t.float().requires_grad_() for t in ins]
    y3, s3 = ops.wkv6_scan(*f32)
    assert torch.isfinite(y3).all()
    assert within(y3.detach(), y.detach(), ref.FWD_RTOL, ref.FWD_ATOL)
    assert within(s3.detach(), s.detach(), ref.FWD_RTOL, ref.FWD_ATOL)
    ((y3 * dy.float()).sum() + (s3 * ds.float()).sum()).backward()
    for leaf, wg in zip(f32, want):
        assert torch.isfinite(leaf.grad).all()
        assert within(leaf.grad, wg, ref.GRAD_RTOL)


@pytest.mark.parametrize("S", LENGTHS)
def test_chunked_scan_and_backward_match_autograd_of_the_loop(S):
    rng = np.random.RandomState(S)
    check_against_the_loop(inputs(rng, S), rng)


@pytest.mark.parametrize("S, zero", [(17, -800.0), (65, -800.0),
                                     (200, -800.0), (200, -np.inf)])
def test_chunked_scan_on_decays_of_zero_and_one(S, zero):
    """A run of decays of 0 (exp(lw) is 0 in float64 and float32) across a
    sub-chunk edge and (past 64) the first chunk boundary, a run of decays
    of 1, one head whose decays are all 0 and one channel of another whose
    decays are all 1.  For lw -inf the loop runs on -800 (the same decays;
    its autograd would multiply 0 by inf)."""
    rng = np.random.RandomState(S + 1)
    ins = inputs(rng, S)
    lw = ins[3]
    lw[:, 10:14] = 0.0
    lw[:, 14:70] = zero
    lw[:, :, 1] = zero
    lw[:, :, 2, 3] = 0.0
    check_against_the_loop(ins, rng, torch.clamp(lw, min=-800.0))


@pytest.mark.parametrize("S, low", [(64, -20.0), (130, -20.0),
                                    (200, -7.0)])
def test_chunked_scan_on_strong_decays(S, low):
    """Log decays uniform in [low, 0] a token, where R~ and K^ folded over a
    whole chunk (r_t e^{c_t}, k_s e^{-c_s}) would overflow: e^{-c_s} reaches
    e^{448} at lw -7 over 64 tokens."""
    rng = np.random.RandomState(S + 2)
    ins = inputs(rng, S)
    ins[3] = torch.from_numpy(low * rng.random_sample(tuple(ins[3].shape)))
    check_against_the_loop(ins, rng)


def _layer0(decays):
    """Layer 0's time mix of the reference's SMOKE init, as numpy: with
    decays "zero and one", head 0's decays all 0 (w_base 6: -exp(w_log)
    <= -104 once the LoRA adds more than -1.4) and head 1's all 1 (w_base
    -40: exp(-exp(-40)) rounds to 1); with "strong", w_base uniform in
    [-1, 3], log decays down to about -20 a token."""
    cfg = jconfigs.get_config("rwkv6-3b", smoke=True)
    params = jax.tree_util.tree_map(np.asarray,
                                    jrwkv.init(jax.random.PRNGKey(0), cfg))
    p = {k: np.array(v[0]) for k, v in params["layers"]["tm"].items()}
    hd = cfg.rwkv.head_dim
    if decays == "zero and one":
        p["w_base"][:hd], p["w_base"][hd:2 * hd] = 6.0, -40.0
    else:
        p["w_base"][:] = np.random.RandomState(5).uniform(
            -1.0, 3.0, p["w_base"].shape)
    return cfg, p


@pytest.mark.parametrize("decays, S", [("zero and one", 1),
                                       ("zero and one", 63),
                                       ("zero and one", 65),
                                       ("zero and one", 200),
                                       ("strong", 130)])
def test_time_mix_forward_and_vjp_match_the_reference(decays, S):
    jcfg, p = _layer0(decays)
    tcfg = tconfigs.get_config("rwkv6-3b", smoke=True)
    rng = np.random.RandomState(S + 3)
    B, D, hd = 2, jcfg.d_model, jcfg.rwkv.head_dim
    ins = [rng.standard_normal((B, S, D)).astype(np.float32),
           rng.standard_normal((B, D)).astype(np.float32),
           0.5 * rng.standard_normal((B, D // hd, hd, hd)).astype(
               np.float32)]
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jout, vjp = jax.vjp(lambda pp, x, px, st: jrwkv.time_mix(pp, jcfg, x, px,
                                                             st),
                        jp, *[jnp.asarray(x) for x in ins])
    cot = [rng.standard_normal(o.shape).astype(np.float32) for o in jout]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cot))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in p.items()}
    tin = [torch.from_numpy(x.copy()).requires_grad_() for x in ins]
    tout = trwkv.time_mix(tp, tcfg, *tin)
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


def test_meta_calls_make_the_buffers_the_card_makes():
    """Under the dry run's ``Tally`` a call on meta tensors makes every
    buffer the card's call makes: a forward that keeps no checkpoints
    still makes them (the card's kernels write them as scratch) with the
    chunks' decays, and a backward makes the gradient of every chunk's end
    state and the decays beside its outputs, du as partials, one a
    chunk."""
    from repro_torch.launch.dryrun import Tally
    B, S, H, hd = 1, 4096, 40, 64

    def m(*shape):
        return torch.empty(shape, device="meta")

    def nbytes(*ts):
        return sum(4 * t.numel() for t in ts)

    x = m(B, S, H, hd)
    ins = (x, x, x, x, m(H, hd), m(B, H, hd, hd))
    ck, dec = m(B, S // 64, H, hd, hd), m(B, S // 64, H, hd)
    with Tally() as tally:
        y, s, none = ops.wkv6_forward(*ins)
    assert none.numel() == 0
    assert tally.peak == nbytes(y, s, ck, dec)
    ds = m(B, H, hd, hd)
    with Tally() as tally:
        dr, dk, dv, dlw, du, ds0 = ops.wkv6_backward(*ins[:5], ck, x, ds)
    assert tuple(du.shape) == (B, H, hd)
    # at the op's return: its outputs with du's partials (one a chunk, the
    # decays' shape) and the scratch
    assert tally.peak == nbytes(dr, dk, dv, dlw, ds0, dec, ck, dec)
    assert 4 * ck.numel() == 41_943_040   # 41.9 MB a layer call
