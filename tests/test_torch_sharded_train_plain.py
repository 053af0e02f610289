"""The train step on an UNSEALED sharded state (security off), which the
dry run's ``--security off`` train cells run: four gloo processes on a
(2, 2) ``make_smoke_mesh`` take granite-3-2b's SMOKE step (float32) on
the state distributed by ``train_state_shardings`` and a batch of two
microbatches in ``batch_shardings`` blocks, against one process's step:

* the loss within 1e-3 and the gradient norm within 1e-4 (the mean over
  the data shards sums in another order);
* each rank's block of the new moments within float32 rounding of the
  same block of one process's (as ``test_torch_sharded_train.py`` holds
  the first moments), and of the new parameters within the cell's lr: the
  first step moves an entry by lr g / (|g| + eps), which a reordered f32
  sum can change by up to lr where |g| is near eps; all in the state's
  placements.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist  # noqa: E402
from repro_torch.core import sealed as sealed_lib  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import TrainState  # noqa: E402

torch.set_num_threads(1)

ARCH, N_RANKS, N_MICRO = "granite-3-2b", 4, 2
LOSS_TOL, NORM_TOL = 1e-3, 1e-4
FIELDS = ("params", "mu", "nu")


def _cell():
    return steps.make_cell(ARCH, "train_4k", smoke=True, device="cpu",
                           security="off")


def _inputs():
    cell = _cell()
    params = cell.model.init(torch.Generator().manual_seed(0), cell.cfg,
                             "cpu")
    data = SyntheticLM(vocab=cell.cfg.vocab, seq_len=16, batch=4, seed=0)
    batch = {k: torch.from_numpy(v)
             for k, v in data.microbatches_at(0, N_MICRO).items()}
    return cell, cell.opt.init(params), batch


def _shardings(tree) -> list:
    """The Sharding leaves of a dict tree in ``tree_leaves`` order (a
    Sharding is a tuple, which ``tree_leaves`` would open)."""
    from repro_torch.parallel.sharding import Sharding
    if isinstance(tree, Sharding):
        return [tree]
    return [s for k in sorted(tree) for s in _shardings(tree[k])]


def _rank(rank, port, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel import sharding as shd

    torch_dist.init_gloo(rank, port, N_RANKS)
    try:
        mesh = make_smoke_mesh(N_RANKS, device_type="cpu")      # (2, 2)
        cell, state, batch = _inputs()
        sh = steps.train_state_shardings(cell, mesh)
        dstate = TrainState(
            step=shd.distribute(state.step, sh.step),
            **{f: sealed_lib.tree_unflatten(getattr(state, f), [
                shd.distribute(x, s) for x, s in zip(
                    sealed_lib.tree_leaves(getattr(state, f)),
                    _shardings(getattr(sh, f)))])
               for f in FIELDS})
        bsh = steps.batch_shardings(
            cell, mesh, {k: (tuple(v.shape), v.dtype)
                         for k, v in batch.items()}, stacked=True)
        dbatch = {k: shd.distribute(v, bsh[k]) for k, v in batch.items()}
        with shd.use(shd.make_ctx(mesh)):
            new, m = steps.make_train_step_fn(cell)(dstate, dbatch)
        res = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "seal_ok": bool(m["seal_ok"]), "n_split": 0}
        coord = mesh.get_coordinate()
        for f in FIELDS:
            olds = sealed_lib.tree_leaves(getattr(dstate, f))
            for i, x in enumerate(sealed_lib.tree_leaves(getattr(new, f))):
                assert x.placements == olds[i].placements
                offs, _ = sealed_lib.block_of(tuple(x.shape), mesh,
                                              x.placements, coord)
                res[f"{f}/{i}"] = x.to_local().numpy()
                res[f"{f}/{i}/offs"] = np.asarray(offs)
                res["n_split"] += x.to_local().numel() < x.numel()
        dist.barrier()
        np.savez(f"{out_dir}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_train_plain")
    cell, state, batch = _inputs()
    one = steps.make_train_step_fn(cell)(state, batch)
    torch_dist.spawn(_rank, N_RANKS, out, timeout=150)
    return one, [dict(np.load(out / f"rank{r}.npz"))
                 for r in range(N_RANKS)]


def test_loss_and_norm_within_limit_of_one_process(runs):
    (_, m), ranks = runs
    for r in ranks:
        assert bool(r["seal_ok"])
        assert abs(float(r["loss"]) - float(m["loss"])) < LOSS_TOL
        assert abs(float(r["grad_norm"]) - float(m["grad_norm"])) < NORM_TOL


@pytest.mark.parametrize("field", FIELDS)
def test_blocks_are_one_process_within_f32_sums(runs, field):
    (new, _), ranks = runs
    want = sealed_lib.tree_leaves(getattr(new, field))
    for r in ranks:
        assert int(r["n_split"]) > 0
        for i, full in enumerate(want):
            got = r[f"{field}/{i}"]
            block = full.numpy()[tuple(slice(o, o + n) for o, n in zip(
                r[f"{field}/{i}/offs"], got.shape))]
            atol = (_cell().opt.lr if field == "params"
                    else 1e-6 * float(np.abs(full.numpy()).max()))
            np.testing.assert_allclose(got, block, rtol=1e-5, atol=atol,
                                       err_msg=f"{field} {i}")
