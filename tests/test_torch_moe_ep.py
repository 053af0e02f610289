"""The port's expert-parallel MoE dispatch (``models/moe_ep.py``) against
the global dispatch and the reference's ``moe_ffn_ep``.

Four gloo processes on the CPU form a (data 2, model 2) mesh; each model
rank keeps 4 of the smoke MoE's 8 experts (top-2, capacity factor 8, so
neither dispatch drops a token).  Weights come from the reference's
``init``.  The reference's ``moe_ffn_ep`` runs in a subprocess with four
host devices on a mesh of Auto axes (``jax.make_mesh``'s default Explicit
axes make the reference's own test fail: ROADMAP, reference behaviours).

Limits: the EP output within 1e-5 of the port's global ``moe_ffn`` and of
the reference's ``moe_ffn_ep``; the loss within 1e-4 and every gradient
within 1e-3 of the global dispatch (the reference test's limits).  A
control that drops the model-group sum of the entering activations'
gradient must exceed 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402

torch.set_num_threads(1)

MOE = dict(n_experts=8, top_k=2, capacity_factor=8.0, shared_expert=True,
           d_ff_shared=128)
B, S = 4, 16
OUT_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-3
EXPERT_LEAVES = ("layers/moe/w_gate", "layers/moe/w_up", "layers/moe/w_down")

REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs
from repro.models import moe, moe_ep, registry
from repro.models.config import MoEConfig
cfg = configs.get_config("moonshot-v1-16b-a3b", smoke=True).with_(
    moe=MoEConfig(**%r))
m = registry.get_model(cfg)
params = m.init(jax.random.PRNGKey(0), cfg)
tok = jax.random.randint(jax.random.PRNGKey(1), (%d, %d), 0, cfg.vocab)
x = jax.random.normal(jax.random.PRNGKey(2), (%d, %d, cfg.d_model))
lp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["moe"])
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {"tok": tok, "x": x, "y_ep": moe_ep.moe_ffn_ep(lp, cfg, x, mesh)}
def walk(t, pre):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, pre + k + "/")
        else:
            out[pre + k] = v
walk(params, "p/")
np.savez(%r, **{k: np.asarray(v) for k, v in out.items()})
"""


def cfg():
    return tconfigs.get_config("moonshot-v1-16b-a3b", smoke=True).with_(
        moe=MoEConfig(**MOE))


def load(path):
    """(params, tokens, x, the reference's EP output) from the npz."""
    ref = dict(np.load(path))
    params = tregistry.params_from_numpy(torch_dist.nest(
        {k[2:]: v for k, v in ref.items() if k.startswith("p/")}), "cpu")
    tok = torch.from_numpy(ref["tok"].astype(np.int64))
    return params, tok, torch.from_numpy(ref["x"]), ref["y_ep"]


def loss_and_grads(params, c, tok):
    params = torch_dist.nest({p: t.clone().requires_grad_(True)
                              for p, t in torch_dist.flat(params).items()})
    loss = tregistry.get_model(c).loss(params, c, {"tokens": tok,
                                                   "labels": tok})
    loss.backward()
    return loss.item(), {p: t.grad.numpy()
                         for p, t in torch_dist.flat(params).items()}


def _rank(rank, port, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import moe_ep
    from repro_torch.parallel import sharding as shd

    torch_dist.init_gloo(rank, port, 4)
    try:
        mesh = make_smoke_mesh(device_type="cpu")          # (2, 2)
        params, tok, x, _ = load(f"{out_dir}/ref.npz")
        c = cfg()
        lp = {k: v[0] for k, v in params["layers"]["moe"].items()
              if k != "shared"}
        res = {"y_ep": moe_ep.moe_ffn_ep(lp, c, x, mesh).numpy()}
        with shd.use(shd.make_ctx(mesh)):
            res["loss"], grads = loss_and_grads(params, c.with_(moe_ep=True),
                                                tok)
            res.update({"g/" + k: v for k, v in grads.items()})
            moe_ep._x_grad_groups = lambda mg, dg: (dg,)
            _, ctl = loss_and_grads(params, c.with_(moe_ep=True), tok)
            res.update({"ctl/" + k: v for k, v in ctl.items()})
        np.savez(f"{out_dir}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep")
    torch_dist.reference(REFERENCE % (MOE, B, S, B, S, str(out / "ref.npz")),
                         n_devices=4)
    torch_dist.spawn(_rank, 4, out, timeout=150)
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def test_ep_output_matches_global_dispatch_and_reference(runs):
    out, ranks = runs
    params, _, x, y_ref = load(out / "ref.npz")
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()
          if k != "shared"}
    want = tmoe.moe_ffn(lp, cfg(), x).numpy()
    for r in ranks:
        err_global = np.abs(r["y_ep"] - want).max()
        err_ref = np.abs(r["y_ep"] - y_ref).max()
        print(f"EP output: {err_global:.3g} from the global dispatch, "
              f"{err_ref:.3g} from the reference's moe_ffn_ep")
        assert err_global <= OUT_TOL and err_ref <= OUT_TOL


def expert_whole(ranks, leaf):
    """The whole expert gradient: each model rank holds its own experts'
    rows (data shard 0's ranks 0 and 1; ranks 2 and 3 hold the same)."""
    for m in (0, 1):
        np.testing.assert_array_equal(ranks[m][leaf], ranks[2 + m][leaf])
    return ranks[0][leaf] + ranks[1][leaf]


def max_grad_err(ranks, want, prefix):
    errs = {}
    for leaf, g in want.items():
        if leaf in EXPERT_LEAVES:
            got = expert_whole(ranks, prefix + leaf)
        else:
            got = ranks[0][prefix + leaf]
        errs[leaf] = float(np.abs(got - g).max())
    return errs


def test_ep_loss_and_grads_match_global_dispatch(runs):
    out, ranks = runs
    params, tok, _, _ = load(out / "ref.npz")
    loss, want = loss_and_grads(params, cfg(), tok)
    for r in ranks:
        assert abs(float(r["loss"]) - loss) <= LOSS_TOL
    for leaf in want:
        if leaf not in EXPERT_LEAVES:        # whole on every rank
            for r in ranks[1:]:
                np.testing.assert_array_equal(r["g/" + leaf],
                                              ranks[0]["g/" + leaf])
    errs = max_grad_err(ranks, want, "g/")
    worst = max(errs.values())
    print(f"EP loss {float(ranks[0]['loss'])} vs {loss}; max grad err "
          f"{worst:.3g} ({max(errs, key=errs.get)})")
    assert worst <= GRAD_TOL, errs
    ctl = max_grad_err(ranks, want, "ctl/")
    print(f"control (no model-group sum of x's gradient): max grad err "
          f"{max(ctl.values()):.3g}")
    assert max(ctl.values()) > GRAD_TOL
