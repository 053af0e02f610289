"""Elastic restore (``train/fault.py::elastic_restore``,
``train/checkpoint.py::restore(shardings=...)``) against the reference's
shardings.

This process saves granite-3-2b's SMOKE train state, sealed (parameters
under the weight spec with tags, moments under the gradient spec), and a
plaintext parameter tree with ``checkpoint.save``.  Four gloo processes
on the CPU restore them onto ``make_smoke_mesh`` (data 2, model 2) from
the abstract states on the meta device.  Bit for bit: the step, every
nonce, and each rank's local block of every ciphertext, tag and
plaintext leaf equal the slice of the saved leaf that the reference's
``NamedSharding`` (``launch/steps.py::train_state_shardings`` and
``params_shardings`` on a (2, 2) mesh of host devices, in device order)
gives device r; each restored leaf carries the placements of the port's
``tree_named_shardings`` of the abstract state.  ``sharding.shard`` redistributes a DTensor to its
logical axes.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist  # noqa: E402
from repro_torch.core.sealed import SealedTensor  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import TrainState  # noqa: E402
from repro_torch.train import checkpoint, trainer  # noqa: E402

torch.set_num_threads(1)

ARCH, STEP = "granite-3-2b", 7
KEY_BYTES = b"elastic-restore-test-key"

REFERENCE = """
import json, numpy as np, jax
from jax.sharding import Mesh
from repro.launch import steps
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
def blocks(shard_tree, abstract):
    out = []
    for s, a in zip(jax.tree_util.tree_leaves(shard_tree),
                    jax.tree_util.tree_leaves(abstract)):
        shape = tuple(a.shape)
        idx = s.devices_indices_map(shape)
        out.append({"shape": shape, "blocks": [
            [list(sl.indices(n))[:2] for sl, n in zip(idx[d], shape)]
            for d in jax.devices()]})
    return out
sealed = steps.make_cell(%r, "train_4k", smoke=True)
plain = steps.make_cell(%r, "train_4k", smoke=True, security="off")
ab = steps.abstract_train_state(sealed)
ap = steps.abstract_params(plain)
json.dump({"state": blocks(steps.train_state_shardings(sealed, mesh, ab), ab),
           "params": blocks(steps.params_shardings(plain, mesh, ap), ap)},
          open(%r, "w"))
"""


def leaves(node) -> list:
    """Leaves in the reference's order (TrainState, SealedTensor fields,
    sorted dict keys)."""
    if isinstance(node, TrainState):
        return [x for c in (node.step, node.params, node.mu, node.nu)
                for x in leaves(c)]
    if isinstance(node, SealedTensor):
        return [node.ct, node.tags, node.nonce]
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in leaves(node[k])]
    return [node]


def saved(cell):
    """The state and parameters this process saves (the weights from a
    seeded generator)."""
    params = cell.model.init(torch.Generator().manual_seed(3), cell.cfg,
                             "cpu")
    state = cell.opt.init(params)
    state.step = torch.tensor(STEP, dtype=torch.int32)
    return trainer.seal_state(state, cell.key, cell.sec), params


def _rank(rank, port, out_dir, paths):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import fault

    torch_dist.init_gloo(rank, port, 4)
    try:
        mesh = make_smoke_mesh(device_type="cpu")                # (2, 2)
        res = {}
        for name, sec in (("state", "trusted"), ("params", "off")):
            cell = steps.make_cell(ARCH, "train_4k", smoke=True,
                                   security=sec, device="cpu")
            if name == "state":
                abstract = steps.abstract_train_state(cell)
                specs = steps.state_logical_specs(cell.cfg, cell.model)
            else:
                abstract = steps.abstract_params(cell)
                specs = cell.model.param_specs(cell.cfg)
            got, step = fault.elastic_restore(paths[name], abstract,
                                              KEY_BYTES, mesh, specs)
            res[f"{name}/step"] = step
            want = leaves(shd.tree_named_shardings(specs, mesh, abstract))
            for i, (leaf, sh) in enumerate(zip(leaves(got), want)):
                if isinstance(leaf, int):
                    res[f"{name}/{i}"] = np.uint32(leaf)
                    continue
                assert isinstance(leaf, DTensor)
                assert leaf.placements == shd.fit_placements(
                    mesh, sh.placements, leaf.shape)
                res[f"{name}/{i}"] = leaf.to_local().numpy()
        x = shd.distribute(torch.arange(32.0).reshape(4, 8),
                           shd.Sharding(mesh, (Replicate(), Replicate())))
        with shd.use(shd.make_ctx(mesh)):
            res["shard"] = shd.shard(x, "data", "model").to_local().numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    torch_dist.reference(REFERENCE % (ARCH, ARCH, str(out / "blocks.json")),
                         n_devices=4)
    cell = steps.make_cell(ARCH, "train_4k", smoke=True, device="cpu")
    state, params = saved(cell)
    paths = {"state": checkpoint.save(str(out), STEP, state, KEY_BYTES),
             "params": checkpoint.save(str(out), 0, params, KEY_BYTES)}
    torch_dist.spawn(_rank, 4, out, paths, timeout=150)
    return ((state, params), json.loads((out / "blocks.json").read_text()),
            [dict(np.load(out / f"rank{r}.npz")) for r in range(4)])


@pytest.mark.parametrize("name", ["state", "params"])
def test_each_rank_holds_the_reference_block_bit_for_bit(name, runs):
    (state, params), ref, ranks = runs
    tree = state if name == "state" else params
    full = leaves(tree)
    assert len(full) == len(ref[name])
    n_sharded = 0
    for r, got in enumerate(ranks):
        assert int(got[f"{name}/step"]) == (STEP if name == "state" else 0)
        for i, (leaf, want) in enumerate(zip(full, ref[name])):
            if isinstance(leaf, int):
                assert int(got[f"{name}/{i}"]) == leaf
                continue
            assert list(leaf.shape) == want["shape"]
            block = tuple(slice(a, b) for a, b in want["blocks"][r])
            np.testing.assert_array_equal(got[f"{name}/{i}"],
                                          leaf.numpy()[block])
            n_sharded += got[f"{name}/{i}"].size < leaf.numel()
    assert n_sharded > 0
    if name == "state":
        sealed = [x for x in leaves(state.params) if isinstance(x, int)]
        assert sealed                      # the params' nonces crossed


def test_shard_redistributes_a_dtensor(runs):
    _, _, ranks = runs
    full = np.arange(32.0).reshape(4, 8)
    for r, got in enumerate(ranks):
        d, m = divmod(r, 2)
        np.testing.assert_array_equal(
            got["shard"], full[2 * d:2 * d + 2, 4 * m:4 * m + 4])
