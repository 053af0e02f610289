"""The port's logical specs, meshes and DTensor placements
(``models/*::param_specs``/``cache_specs``/``state_specs``,
``launch/mesh.py``, ``parallel/sharding.py``, the sharding half of
``launch/steps.py``) against the JAX reference.

Equal trees: every family's parameter, cache and state specs for all ten
configs (published and SMOKE, FSDP on and off).  Equal blocks: on the
meshes (4, 2) and (2, 2, 2), for every leaf of each SMOKE config's
parameter tree and decode state, of granite's and moonshot's sealed ones
(ciphertext, tags, nonce), and of a stacked training batch, the block of the global tensor that rank r
holds under the port's placements equals the block that the reference's
``NamedSharding.devices_indices_map`` gives device r of a mesh laid out
in device order.  The reference's blocks come from a subprocess with
eight host devices; the port's ranks are eight ranks of a fake process
group in this process (no communication: a block is shape arithmetic).
"""
import json

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor._utils import (  # noqa: E402
    compute_local_shape_and_global_offset)
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa

import torch_dist  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.sealed import SealedTensor  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

MESHES = {"4x2": ((4, 2), ("data", "model"), 1),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"), 2)}
# sealed trees (ciphertext, tags, nonce) of a dense and an MoE config; the
# plaintext trees of all ten
SEALED_ARCHS = ("granite-3-2b", "moonshot-v1-16b-a3b")

REFERENCE = """
import json, numpy as np, jax
from jax.sharding import Mesh
from repro import configs
from repro.launch import steps
meshes = %r
def name(k):
    if hasattr(k, "key") and isinstance(k.key, str):
        return k.key
    if hasattr(k, "name"):
        return k.name
    return ("ct", "tags", "nonce")[k.key]
def blocks(shard_tree, abstract):
    out = {}
    for (path, s), a in zip(
            jax.tree_util.tree_flatten_with_path(shard_tree)[0],
            jax.tree_util.tree_leaves(abstract)):
        shape = tuple(a.shape)
        idx = s.devices_indices_map(shape)
        out["/".join(name(k) for k in path)] = {
            "shape": shape,
            "blocks": [[list(sl.indices(n))[:2] for sl, n in zip(idx[d], shape)]
                       for d in jax.devices()]}
    return out
cells = {(arch, sec): steps.make_cell(arch, "decode_32k", smoke=True,
                                     security=sec)
         for arch in configs.ARCH_IDS for sec in ("off", "trusted")
         if sec == "off" or arch in %r}
abstract = {k: (steps.abstract_params(c), steps.abstract_decode_state(c))
            for k, c in cells.items()}
res = {}
for mname, (shape, axes, _) in meshes.items():
    mesh = Mesh(np.array(jax.devices()).reshape(shape), axes)
    for (arch, sec), cell in cells.items():
        ab, ds = abstract[arch, sec]
        res[f"{mname}/{arch}/{sec}/params"] = blocks(
            steps.params_shardings(cell, mesh, ab), ab)
        res[f"{mname}/{arch}/{sec}/decode"] = blocks(
            steps.decode_state_shardings(cell, mesh, ds), ds)
    cell = steps.make_cell("granite-3-2b", "train_4k", smoke=True)
    specs = steps.stacked_batch_specs(cell, 2, microbatch=4)
    res[f"{mname}/batch"] = blocks(
        steps.batch_shardings(cell, mesh, specs, True), specs)
json.dump(res, open(%r, "w"))
"""


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_spec_trees_equal_reference(arch):
    for smoke in (False, True):
        jc = jconfigs.get_config(arch, smoke=smoke)
        tc = tconfigs.get_config(arch, smoke=smoke)
        assert (tregistry.get_model(tc).param_specs(tc)
                == jregistry.get_model(jc).param_specs(jc))
        for sealed in (False, True):
            assert (tregistry.decode_state_specs(tc, sealed)
                    == jregistry.decode_state_specs(jc, sealed))


@pytest.fixture(scope="module")
def reference_blocks(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharding") / "blocks.json"
    torch_dist.reference(REFERENCE % (MESHES, SEALED_ARCHS, str(path)),
                         n_devices=8)
    return json.loads(path.read_text())


def fake_rank(rank: int, world: int):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def walk(shardings, abstract, pre=""):
    """[(path, sharding, shape)] of two trees of one structure."""
    if isinstance(abstract, SealedTensor):
        return [(pre + f, getattr(shardings, f),
                 () if f == "nonce" else tuple(getattr(abstract, f).shape))
                for f in ("ct", "tags", "nonce")]
    if isinstance(abstract, dict):
        return [x for k in sorted(abstract)
                for x in walk(shardings[k], abstract[k], f"{pre}{k}/")]
    if isinstance(abstract, tuple) and len(abstract) == 2:   # (shape, dt)
        return [(pre[:-1], shardings, tuple(abstract[0]))]
    return [(pre[:-1], shardings, tuple(getattr(abstract, "shape", ())))]


def port_block(sharding, shape):
    pl = shd.fit_placements(sharding.mesh, sharding.placements, shape)
    size, off = compute_local_shape_and_global_offset(shape, sharding.mesh,
                                                      pl)
    return [[o, o + n] for o, n in zip(off, size)]


@pytest.mark.parametrize("mname", list(MESHES))
def test_blocks_equal_reference_named_sharding(mname, reference_blocks):
    shape, axes, pods = MESHES[mname]
    cells = {(a, sec): steps.make_cell(a, "decode_32k", smoke=True,
                                       security=sec, device="cpu")
             for a in tconfigs.ARCH_IDS for sec in ("off", "trusted")
             if sec == "off" or a in SEALED_ARCHS}
    abstract = {k: (steps.abstract_params(c), steps.abstract_decode_state(c))
                for k, c in cells.items()}
    n_leaves = 0
    try:
        for rank in range(8):
            fake_rank(rank, 8)
            mesh = tmesh.make_smoke_mesh(8, pods=pods, device_type="cpu")
            assert mesh.mesh_dim_names == axes
            assert tuple(mesh.shape) == shape
            trees = {}
            for (arch, sec), cell in cells.items():
                ab, ds = abstract[arch, sec]
                trees[f"{arch}/{sec}/params"] = walk(
                    steps.params_shardings(cell, mesh, ab), ab)
                trees[f"{arch}/{sec}/decode"] = walk(
                    steps.decode_state_shardings(cell, mesh, ds), ds)
            cell = steps.make_cell("granite-3-2b", "train_4k", smoke=True,
                                   device="cpu")
            specs = steps.stacked_batch_specs(cell, 2, microbatch=4)
            trees["batch"] = walk(
                steps.batch_shardings(cell, mesh, specs, True), specs)
            for name, leaves in trees.items():
                want = reference_blocks[f"{mname}/{name}"]
                assert sorted(p for p, _, _ in leaves) == sorted(want)
                for path, sh, leaf_shape in leaves:
                    assert list(leaf_shape) == want[path]["shape"], path
                    assert (port_block(sh, leaf_shape)
                            == want[path]["blocks"][rank]), (name, path)
                    n_leaves += 1
    finally:
        dist.destroy_process_group()
    assert n_leaves > 8 * 200


def test_smoke_and_production_mesh_shapes():
    cases = [((8, 1), (4, 2), ("data", "model")),
             ((8, 2), (2, 2, 2), ("pod", "data", "model")),
             ((6, 1), (3, 2), ("data", "model")),
             ((3, 1), (3, 1), ("data", "model")),
             ((6, 2), (2, 3, 1), ("pod", "data", "model"))]
    try:
        for (n, pods), shape, names in cases:
            fake_rank(0, n)
            m = tmesh.make_smoke_mesh(pods=pods, device_type="cpu")
            assert (tuple(m.shape), m.mesh_dim_names) == (shape, names)
            assert m.device_type == "cpu"
        fake_rank(5, 16)
        m = tmesh.make_production_mesh(device_type="cpu")
        assert (tuple(m.shape), m.mesh_dim_names) == ((2, 8),
                                                      ("data", "model"))
        with pytest.raises(ValueError):
            tmesh.make_smoke_mesh(4, device_type="cpu")
        fake_rank(5, 32)
        m = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert tuple(m.shape) == (2, 2, 8)
    finally:
        dist.destroy_process_group()


def test_abstract_states_are_meta_and_sealed():
    """The published moonshot's sealed train state (16 B parameters) takes
    no memory: every tensor leaf is on the meta device; sealed leaves carry
    the tags' chunk count."""
    cell = steps.make_cell("moonshot-v1-16b-a3b", "train_4k", device="cpu")
    state = steps.abstract_train_state(cell)
    leaves = [(p, t) for p, t in torch_dist.flat(state.params).items()]
    assert all(isinstance(t, SealedTensor) for _, t in leaves)
    assert all(t.ct.is_meta and t.tags.is_meta for _, t in leaves)
    wg = state.params["layers"]["moe"]["w_gate"]
    assert tuple(wg.ct.shape) == (48, 64, 2048, 1408)
    assert wg.tags.shape[-1] == 2          # 704 words in 352-word chunks
    assert state.step.is_meta


def test_shard_is_a_no_op_without_a_context_or_on_a_plain_tensor():
    x = torch.arange(6.0).reshape(2, 3)
    assert shd.shard(x, "data", None) is x
    try:
        fake_rank(0, 2)
        mesh = tmesh.make_smoke_mesh(device_type="cpu")
        with shd.use(shd.make_ctx(mesh)):
            assert shd.active().mesh is mesh
            assert shd.shard(x, "data", None) is x
        assert shd.active() is None
    finally:
        dist.destroy_process_group()


def test_tree_named_shardings_fit_to_the_params_shardings():
    """The shape-free shardings of a spec tree, fitted to each leaf's shape
    as ``distribute`` fits them, are the placements ``params_shardings``
    gives the plaintext tree, on both meshes; 'r' is replicated."""
    cell = steps.make_cell("granite-3-2b", "train_4k", smoke=True,
                           security="off", device="cpu")
    specs = cell.model.param_specs(cell.cfg)
    abstract = steps.abstract_params(cell)
    try:
        for _, (shape, axes, pods) in MESHES.items():
            fake_rank(0, 8)
            mesh = tmesh.make_smoke_mesh(8, pods=pods, device_type="cpu")
            named = walk(shd.tree_named_shardings(specs, mesh), abstract)
            fitted = walk(steps.params_shardings(cell, mesh, abstract),
                          abstract)
            for (path, sh, leaf_shape), (_, want, _) in zip(named, fitted):
                assert shd.fit_placements(mesh, sh.placements, leaf_shape) \
                    == want.placements, path
            assert shd.tree_named_shardings("r", mesh) == shd.replicated(mesh)
    finally:
        dist.destroy_process_group()
