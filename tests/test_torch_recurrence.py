"""RWKV-6's and Mamba-2's recurrences as scan ops (``kernels/wkv6_scan``,
``kernels/ssd_scan``), on the CPU.

* The plain forward and its explicit backward (from state checkpoints)
  against torch autograd through the per-token loop, in float64: one
  token, lengths off the checkpoint interval, several chunks, a nonzero
  initial state, a gradient into the final state, B > 1; and the custom op
  (float32; the kernels' chunked algorithm) within the stated limits of
  the same.  Both scans take the log decay.
* ``rwkv.time_mix`` and ``ssm.m2_forward`` at SMOKE size with layer 0 of
  the reference's ``init`` carried across as numpy: the forward within
  1e-5 max|ref| + 1e-6 of the JAX package's, and the VJP by ``jax.vjp``
  against torch autograd through the op, each gradient within 1e-4 of its
  largest entry.
* The meta path: outputs of the right shapes (the checkpoints and the
  per-head partials included), ``meta_launches`` counted and ``launches``
  not, and the FLOP formulas seen by ``FlopCounterMode``.
* A SMOKE config's loss and gradients under remat "none", "full" and
  "dots" (the op recomputed inside a checkpoint) agree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.wkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6_scan import ref as wkv_ref  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

torch.set_num_threads(1)

EXACT = 1e-10        # float64: the explicit backward against autograd
# one token; lengths off the checkpoint interval of 64 with a nonzero
# initial state and a gradient into the final state; B > 1; and past it:
# one token into a second chunk, several chunks at B > 1
LENGTHS = [(1, 1), (1, 13), (2, 21), (3, 16)]
SSD_LENGTHS = LENGTHS + [(1, 65), (2, 130)]


def within(got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= rtol * np.abs(want).max() + atol


def wkv_loop(r, k, v, lw, u, s):
    ys = []
    w = torch.exp(lw)
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, 1), s


def ssd_loop(la, x, b, c, h):
    ys = []
    a = torch.exp(la)
    for t in range(x.shape[1]):
        h = (a[:, t, :, None, None] * h
             + torch.einsum("bhp,bn->bhpn", x[:, t], b[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t]))
    return torch.stack(ys, 1), h


def wkv_inputs(rng, B, S, H=3, hd=5):
    r, k, v = (rng.standard_normal((B, S, H, hd)) for _ in range(3))
    lw = -np.exp(rng.standard_normal((B, S, H, hd)) - 1)
    return [torch.from_numpy(x) for x in (
        r, k, v, lw, 0.3 * rng.standard_normal((H, hd)),
        rng.standard_normal((B, H, hd, hd)))]


def ssd_inputs(rng, B, S, H=3, P=4, N=6):
    la = -np.log1p(np.exp(rng.standard_normal((B, S, H))))
    return [torch.from_numpy(x) for x in (
        la, rng.standard_normal((B, S, H, P)), rng.standard_normal((B, S, N)),
        rng.standard_normal((B, S, N)), rng.standard_normal((B, H, P, N)))]


def autograd_of(loop, ins, rng):
    leaves = [t.clone().requires_grad_() for t in ins]
    y, s = loop(*leaves)
    dy = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    ds = torch.from_numpy(rng.standard_normal(tuple(s.shape)))
    grads = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
    return (y.detach(), s.detach()), dy, ds, grads


@pytest.mark.parametrize("B, S", SSD_LENGTHS)
def test_wkv6_plain_scan_and_backward_match_autograd_of_the_loop(B, S):
    rng = np.random.RandomState(S)
    ins = wkv_inputs(rng, B, S)
    (y, s), dy, ds, grads = autograd_of(wkv_loop, ins, rng)
    y2, s2, ck = wkv_ref.wkv6_forward_ref(*ins, save=True)
    assert tuple(ck.shape) == (B, -(-S // wkv_ref.CHUNK), 3, 5, 5)
    assert within(y2, y, EXACT) and within(s2, s, EXACT)
    mine = list(wkv_ref.wkv6_backward_ref(*ins[:5], ck, dy, ds))
    mine[4] = mine[4].sum(0)                   # du per (b, h) -> du
    for g, want in zip(mine, grads):
        assert within(g, want, EXACT)
    # the custom op in float32 under autograd, within the stated limits
    leaves = [t.float().requires_grad_() for t in ins]
    y3, s3 = wkv_ops.wkv6_scan(*leaves)
    assert within(y3.detach(), y, wkv_ref.FWD_RTOL, wkv_ref.FWD_ATOL)
    ((y3 * dy.float()).sum() + (s3 * ds.float()).sum()).backward()
    for leaf, want in zip(leaves, grads):
        assert within(leaf.grad, want, wkv_ref.GRAD_RTOL)


@pytest.mark.parametrize("B, S", SSD_LENGTHS)
def test_ssd_plain_scan_and_backward_match_autograd_of_the_loop(B, S):
    rng = np.random.RandomState(S + 100)
    ins = ssd_inputs(rng, B, S)
    (y, h), dy, dh, grads = autograd_of(ssd_loop, ins, rng)
    y2, h2, ck = ssd_ref.ssd_forward_ref(*ins, save=True)
    assert tuple(ck.shape) == (B, -(-S // ssd_ref.CHUNK), 3, 4, 6)
    assert within(y2, y, EXACT) and within(h2, h, EXACT)
    mine = list(ssd_ref.ssd_backward_ref(*ins[:4], ck, dy, dh))
    mine[2], mine[3] = mine[2].sum(2), mine[3].sum(2)   # per head -> all
    for g, want in zip(mine, grads):
        assert within(g, want, EXACT)
    leaves = [t.float().requires_grad_() for t in ins]
    y3, h3 = ssd_ops.ssd_scan(*leaves)
    assert within(y3.detach(), y, ssd_ref.FWD_RTOL, ssd_ref.FWD_ATOL)
    ((y3 * dy.float()).sum() + (h3 * dh.float()).sum()).backward()
    for leaf, want in zip(leaves, grads):
        assert within(leaf.grad, want, ssd_ref.GRAD_RTOL)


def _layer0(jmodel, cfg, sub):
    """Layer 0's ``sub`` block of the reference's init, as numpy."""
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0), cfg))
    return jax.tree_util.tree_map(lambda a: a[0], params["layers"][sub])


def _compare_vjp(jfn, tfn, np_params, np_inputs, rng):
    """The forward of ``jfn`` (JAX) and ``tfn`` (torch) on the same numpy
    parameters and inputs within the forward limit, and their VJPs of the
    same random cotangents within the gradient limit, leaf by leaf."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jin = [jnp.asarray(x) for x in np_inputs]
    jout, vjp = jax.vjp(jfn, jp, *jin)
    cot = [rng.standard_normal(o.shape).astype(np.float32) for o in jout]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cot))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in np_params.items()}
    tin = [torch.from_numpy(x.copy()).requires_grad_() for x in np_inputs]
    tout = tfn(tp, *tin)
    for t, j in zip(tout, jout):
        assert within(t.detach().numpy(), j, wkv_ref.FWD_RTOL,
                      wkv_ref.FWD_ATOL)
    torch.autograd.backward(list(tout),
                            [torch.from_numpy(c) for c in cot])
    for name in np_params:
        assert within(tp[name].grad.numpy(), jgrads[0][name],
                      wkv_ref.GRAD_RTOL), name
    for t, j in zip(tin, jgrads[1:]):
        assert within(t.grad.numpy(), j, wkv_ref.GRAD_RTOL)


def test_time_mix_forward_and_vjp_match_the_reference():
    """RWKV-6's time mix at SMOKE size (d_model 128, 2 heads of 64), 2
    sequences of 13 tokens, a nonzero shift and WKV state."""
    jcfg = jconfigs.get_config("rwkv6-3b", smoke=True)
    tcfg = tconfigs.get_config("rwkv6-3b", smoke=True)
    p = _layer0(jrwkv, jcfg, "tm")
    rng = np.random.RandomState(3)
    B, S, D, hd = 2, 13, jcfg.d_model, jcfg.rwkv.head_dim
    ins = [rng.standard_normal((B, S, D)).astype(np.float32),
           rng.standard_normal((B, D)).astype(np.float32),
           0.5 * rng.standard_normal((B, D // hd, hd, hd)).astype(
               np.float32)]
    _compare_vjp(lambda pp, x, px, st: jrwkv.time_mix(pp, jcfg, x, px, st),
                 lambda pp, x, px, st: trwkv.time_mix(pp, tcfg, x, px, st),
                 p, ins, rng)


def test_m2_forward_and_vjp_match_the_reference():
    """Mamba-2's block at zamba2-1.2b's SMOKE size (16 heads of p 16, N 8),
    2 sequences of 13 tokens, a nonzero SSM and conv state."""
    jcfg = jconfigs.get_config("zamba2-1.2b", smoke=True)
    tcfg = tconfigs.get_config("zamba2-1.2b", smoke=True)
    p = _layer0(jssm, jcfg, "m2")
    d_inner, H, hp, N = tssm._m2_dims(tcfg)
    rng = np.random.RandomState(4)
    B, S = 2, 13
    ins = [rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32),
           0.5 * rng.standard_normal((B, H, hp, N)).astype(np.float32),
           rng.standard_normal((B, jcfg.ssm.conv_width - 1,
                                d_inner + 2 * N)).astype(np.float32)]
    _compare_vjp(lambda pp, x, h, c: jssm.m2_forward(pp, jcfg, x, h, c),
                 lambda pp, x, h, c: tssm.m2_forward(pp, tcfg, x, h, c),
                 p, ins, rng)


@pytest.mark.parametrize("save", [False, True])
def test_scans_on_meta_give_shapes_and_count_launches(save):
    """One forward each, and with checkpoints one backward: outputs of the
    right shapes (checkpoints [B, ceil(S/64), H, hd, hd] for the WKV,
    [B, ceil(S/64), H, p, N] for the SSD, dB and dC per head), one meta
    launch each, no real launch."""
    B, S, H, hd, P, N = 2, 20, 3, 64, 16, 8

    def m(*shape):
        return torch.empty(shape, device="meta")
    counters = (wkv_ops.wkv6_forward, wkv_ops.wkv6_backward,
                ssd_ops.ssd_forward, ssd_ops.ssd_backward)
    meta0 = [f.meta_launches for f in counters]
    real0 = [f.launches for f in counters]
    x = m(B, S, H, hd)
    y, s, ck = wkv_ops.wkv6_forward(x, x, x, x, m(H, hd), m(B, H, hd, hd),
                                    save)
    assert (tuple(y.shape), tuple(s.shape)) == ((B, S, H, hd),
                                                (B, H, hd, hd))
    assert tuple(ck.shape) == ((B, 1, H, hd, hd) if save else (0,))
    y2, h, ck2 = ssd_ops.ssd_forward(m(B, S, H), m(B, S, H, P), m(B, S, N),
                                     m(B, S, N), m(B, H, P, N), save)
    assert (tuple(y2.shape), tuple(h.shape)) == ((B, S, H, P), (B, H, P, N))
    assert tuple(ck2.shape) == ((B, 1, H, P, N) if save else (0,))
    if save:
        grads = wkv_ops.wkv6_backward(x, x, x, x, m(H, hd), ck, x,
                                      m(B, H, hd, hd))
        assert [tuple(g.shape) for g in grads] == [(B, S, H, hd)] * 4 + [
            (B, H, hd), (B, H, hd, hd)]
        grads = ssd_ops.ssd_backward(m(B, S, H), m(B, S, H, P), m(B, S, N),
                                     m(B, S, N), ck2, m(B, S, H, P),
                                     m(B, H, P, N))
        assert [tuple(g.shape) for g in grads] == [
            (B, S, H), (B, S, H, P), (B, S, H, N), (B, S, H, N),
            (B, H, P, N)]
    assert [f.meta_launches - n for f, n in zip(counters, meta0)] == (
        [1, 1, 1, 1] if save else [1, 0, 1, 0])
    assert [f.launches for f in counters] == real0


def test_flop_counter_counts_the_scans_by_their_formulas():
    """``FlopCounterMode`` sees each scan as one op and counts its formula:
    7 and 14 FLOPs a state entry a token for the WKV forward and backward,
    5 and 14 for the SSD's; the plain loop inside adds nothing."""
    from torch.utils.flop_counter import FlopCounterMode
    rng = np.random.RandomState(0)
    B, S, H, hd, P, N = 1, 9, 2, 5, 4, 6
    wins = [t.float().requires_grad_() for t in wkv_inputs(rng, B, S, H, hd)]
    sins = [t.float().requires_grad_()
            for t in ssd_inputs(rng, B, S, H, P, N)]
    for scan, ins, fwd, bwd in (
            (wkv_ops.wkv6_scan, wins, wkv_ops.forward_flops(B, S, H, hd),
             wkv_ops.backward_flops(B, S, H, hd)),
            (ssd_ops.ssd_scan, sins, ssd_ops.forward_flops(B, S, H, P, N),
             ssd_ops.backward_flops(B, S, H, P, N))):
        with FlopCounterMode(display=False) as fc:
            y, s = scan(*ins)
        assert fc.get_total_flops() == fwd
        with FlopCounterMode(display=False) as fc:
            (y.sum() + s.sum()).backward()
        assert fc.get_total_flops() == bwd
    assert wkv_ops.forward_flops(1, 4096, 40, 64) == 7 * 4096 * 40 * 64 * 64


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_scans_under_every_remat_give_the_same_gradients(arch):
    """The loss and its gradients of a SMOKE config are the same with
    remat "none", "full" (non-reentrant checkpoint: the scan op runs
    again in the backward) and "dots" (the selective policy recomputes
    the op, keeping the matmuls)."""
    from repro_torch.core.sealed import tree_leaves, tree_unflatten
    from repro_torch.models import registry
    cfg = tconfigs.get_config(arch, smoke=True)
    rng = np.random.RandomState(7)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 11)))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    base = registry.get_model(cfg).init(torch.Generator().manual_seed(0),
                                        cfg, "cpu")
    out = {}
    for remat in ("none", "full", "dots"):
        c = cfg.with_(remat=remat)
        leaves = [x.clone().requires_grad_() for x in tree_leaves(base)]
        params = tree_unflatten(base, leaves)
        loss = registry.get_model(c).loss(params, c, batch)
        out[remat] = (float(loss), torch.autograd.grad(loss, leaves))
    for remat in ("full", "dots"):
        assert out[remat][0] == pytest.approx(out["none"][0], rel=1e-6)
        for g, want in zip(out[remat][1], out["none"][1]):
            assert within(g, want, 1e-5, 1e-7)
