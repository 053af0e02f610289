"""The sealed train step on a sharded state (``train/trainer.py`` and
``core/sealed.py`` on DTensor leaves) against one process and the
reference.

The counterpart of ``tests/test_distributed.py::
test_sharded_sealed_train_step_runs``: granite-3-2b's SMOKE config in
float32, the reference's weights (``init(PRNGKey(0))``), its
``SyntheticLM(seq_len=16, batch=8, seed=0)`` and two microbatches.  This
process seals the state and takes the port's one-process step (at the
cell's lr and at lr 0) and the reference's one-device ``jax.jit`` step.
The reference's step runs with security off: its loss is the sealed
step's (unsealing is exact), and its sealed step takes about a minute to
compile on the CPU.  Eight gloo processes restore the sealed state onto a
4 x 2 ``make_smoke_mesh`` with ``elastic_restore``, take the batch in
``batch_shardings`` blocks and run ``make_train_step_fn`` under
``shd.use(shd.make_ctx(mesh))``:

* the loss is within 1e-3 of both, and ``seal_ok`` true, on every rank;
* at lr 0 every rank's block of the new parameters' ciphertext and tags
  equals the same block of the one-process step's, bit for bit;
* a flipped ciphertext bit in one rank's block of a leaf sharded on its
  last axis makes ``seal_ok`` false on all eight and poisons the state;
* each rank holds only its blocks, at rest and after the step;
* the step in place gives the default step's blocks;
* ``seal`` of a DTensor (each rank its block) gives the restored blocks.

The CTR column offset and the MAC tags of a block's own chunks, moved to
their place by ``mac.reposition``, are checked against whole rows here
too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_dist  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.core import cipher, mac  # noqa: E402
from repro_torch.core.policy import SealedSpec  # noqa: E402
from repro_torch.core import sealed as sealed_lib  # noqa: E402
from repro_torch.kernels.ctr_cipher.ops import ctr_xor  # noqa: E402
from repro_torch.kernels.tree_mac.ops import mac_tags  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import checkpoint, trainer  # noqa: E402

torch.set_num_threads(1)

ARCH, N_RANKS, N_MICRO = "granite-3-2b", 8, 2
KEY_BYTES = b"sharded-train-step-test-key"
LOSS_TOL = 1e-3
TAMPER_RANK, TAMPER_LEAF = 5, "layers/attn/wq"     # sharded on its last axis


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _cell(chunk_words, lr=None):
    """granite's SMOKE cell on the CPU, its weights and moments tagged in
    chunks of ``chunk_words``."""
    cell = steps.make_cell(ARCH, "train_4k", smoke=True, device="cpu")
    spec = SealedSpec(chunk_words=chunk_words)
    cell.sec = dataclasses.replace(cell.sec, weights=spec, grads=spec)
    if lr is not None:
        cell.opt = AdamW(lr=lr, state_dtype=cell.opt.state_dtype)
    return cell


def _rank(rank, port, out_dir, path, batch, chunk_words):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import fault

    torch_dist.init_gloo(rank, port, N_RANKS)
    try:
        mesh = make_smoke_mesh(N_RANKS, device_type="cpu")     # (4, 2)
        cell = _cell(chunk_words)
        abstract = steps.abstract_train_state(cell)
        specs = steps.state_logical_specs(cell.cfg, cell.model)
        state, _ = fault.elastic_restore(path, abstract, KEY_BYTES, mesh,
                                         specs)
        bsh = steps.batch_shardings(
            cell, mesh, {k: (v.shape, v.dtype) for k, v in batch.items()},
            stacked=True)
        mb = {k: shd.distribute(torch.from_numpy(v), bsh[k])
              for k, v in batch.items()}
        coord = mesh.get_coordinate()
        res = {}

        def blocks(tree, name):
            for p, st in _paths(tree).items():
                for f in ("ct", "tags"):
                    d = getattr(st, f)
                    offs, _ = sealed_lib.block_of(tuple(d.shape), mesh,
                                                  d.placements, coord)
                    res[f"{name}/{p}/{f}"] = d.to_local().numpy()
                    res[f"{name}/{p}/{f}/offs"] = np.asarray(offs)

        # at rest: only this rank's blocks, and the bytes they take
        held = whole = 0
        for st in sealed_lib.tree_leaves((state.params, state.mu,
                                          state.nu)):
            for d in (st.ct, st.tags):
                assert isinstance(d, DTensor)
                _, sizes = sealed_lib.block_of(tuple(d.shape), mesh,
                                               d.placements, coord)
                local = d.to_local()
                assert tuple(local.shape) == tuple(sizes)
                held += local.numel() * local.element_size()
                whole += d.numel() * local.element_size()
                split = any(isinstance(p, Shard) and mesh.size(i) > 1
                            for i, p in enumerate(d.placements))
                res.setdefault("n_split", 0)
                res["n_split"] += split
                assert not split or local.numel() < d.numel()
        res["held"], res["whole"] = held, whole

        # seal from plaintext blocks: the restored blocks
        plain, ok = sealed_lib.unseal_tree(state.params, cell.key)
        again = sealed_lib.seal_tree(plain, cell.key, cell.sec.weights,
                                     1 << 8)
        res["reseal_equal"] = all(
            torch.equal(getattr(a, f).to_local(), getattr(b, f).to_local())
            and getattr(a, f).placements == getattr(b, f).placements
            for a, b in zip(sealed_lib.tree_leaves(again),
                            sealed_lib.tree_leaves(state.params))
            for f in ("ct", "tags"))
        res["unseal_ok"] = bool(ok)

        with shd.use(shd.make_ctx(mesh)):
            for name, lr in (("step", None), ("lr0", 0.0)):
                fn = steps.make_train_step_fn(_cell(chunk_words, lr))
                new, m = fn(state, mb)
                res[f"{name}/loss"] = float(m["loss"])
                res[f"{name}/seal_ok"] = bool(m["seal_ok"])
                res[f"{name}/grad_norm"] = float(m["grad_norm"])
                trees = [(x.params, x.mu, x.nu) for x in (new, state)]
                res[f"{name}/placements"] = new.step.placements == \
                    state.step.placements and all(
                        getattr(a, f).placements == getattr(b, f).placements
                        for a, b in zip(*map(sealed_lib.tree_leaves, trees))
                        for f in ("ct", "tags"))
                if name == "lr0":
                    blocks(new.params, name)
                else:
                    default = new
                    for p, st in _paths(new.mu).items():
                        x, _ = sealed_lib.unseal(st, cell.key)
                        offs, _ = sealed_lib.block_of(
                            tuple(x.shape), mesh, x.placements, coord)
                        res[f"mu/{p}"] = x.to_local().numpy()
                        res[f"mu/{p}/offs"] = np.asarray(offs)
            # in place, on a state restored again: the default's blocks
            fresh, _ = fault.elastic_restore(path, abstract, KEY_BYTES,
                                             mesh, specs)
            ip, m = steps.make_train_step_fn(_cell(chunk_words),
                                             in_place=True)(fresh, mb)
            trees = [(x.params, x.mu, x.nu) for x in (ip, default)]
            res["in_place_equal"] = float(m["loss"]) == res["step/loss"] and \
                all(torch.equal(getattr(a, f).to_local(),
                                getattr(b, f).to_local())
                    for a, b in zip(*map(sealed_lib.tree_leaves, trees))
                    for f in ("ct", "tags"))
            # one flipped ciphertext bit in one rank's block
            st = _paths(state.params)[TAMPER_LEAF]
            assert isinstance(st.ct.placements[1], Shard)
            if rank == TAMPER_RANK:
                st.ct.to_local()[0, 0, 0] ^= 1
            new, m = steps.make_train_step_fn(_cell(chunk_words))(state, mb)
            res["tamper/seal_ok"] = bool(m["seal_ok"])
            # every rank unseals every leaf: each unseal may gather
            res["tamper/poisoned"] = all([
                bool(torch.isnan(sealed_lib.unseal(x, cell.key)[0]
                                 .to_local()).all())
                for x in sealed_lib.tree_leaves((new.params, new.mu,
                                                 new.nu))])
        dist.barrier()
        np.savez(f"{out_dir}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """The batch, the reference's weights and its one-device step's loss
    (security off: the same loss)."""
    jcell = jsteps.make_cell(ARCH, "train_4k", smoke=True, security="off")
    data = JSyntheticLM(vocab=jcell.cfg.vocab, seq_len=16, batch=8, seed=0)
    batch = data.microbatches_at(0, N_MICRO)
    jparams = jcell.model.init(jax.random.PRNGKey(0), jcell.cfg)
    _, jm = jax.jit(jsteps.make_train_step_fn(jcell))(
        jcell.opt.init(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, jax.tree_util.tree_map(np.asarray, jparams), float(
        jm["loss"])


# 512 words (the default) is one chunk a row at SMOKE width: the ranks of a
# row block gather its ciphertext to tag it; 16 makes each rank's columns
# whole chunks, which it tags itself
@pytest.fixture(scope="module", params=[512, 16],
                ids=["whole-row-chunks", "own-chunks"])
def runs(request, reference, tmp_path_factory):
    chunk_words = request.param
    batch, jparams, ref_loss = reference
    out = tmp_path_factory.mktemp(f"sharded_train_{chunk_words}")
    # the port's one-process sealed step from the same weights
    cell = _cell(chunk_words)
    params = transformer.params_from_numpy(jparams, "cpu")
    state = trainer.seal_state(cell.opt.init(params), cell.key, cell.sec)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    one = {}
    for name, lr in (("step", None), ("lr0", 0.0)):
        one[name] = steps.make_train_step_fn(_cell(chunk_words, lr))(state,
                                                                     tb)
    path = checkpoint.save(str(out), 0, state, KEY_BYTES)
    torch_dist.spawn(_rank, N_RANKS, out, path, batch, chunk_words,
                     timeout=150)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(N_RANKS)]
    return ref_loss, one, ranks


def test_loss_within_limit_of_one_process_and_reference(runs):
    ref_loss, one, ranks = runs
    one_loss = float(one["step"][1]["loss"])
    assert abs(one_loss - ref_loss) < LOSS_TOL
    for r in ranks:
        for name in ("step", "lr0"):
            assert abs(float(r[f"{name}/loss"]) - one_loss) < LOSS_TOL
            assert abs(float(r[f"{name}/loss"]) - ref_loss) < LOSS_TOL
    assert len({float(r["step/loss"]) for r in ranks}) == 1
    assert len({float(r["step/grad_norm"]) for r in ranks}) == 1
    assert abs(float(ranks[0]["step/grad_norm"])
               - float(one["step"][1]["grad_norm"])) < 1e-4


def test_first_moments_equal_one_process_within_f32_sums(runs):
    """mu after one step is (1 - b1) times the clipped mean gradient: each
    rank's block of it equals one process's, up to the order of the f32
    sums over the data shards."""
    _, one, ranks = runs
    want = _paths(trainer.unseal_state_host(
        one["step"][0], _cell(16).key, _cell(16).sec).mu)
    for r in ranks:
        for p, full in want.items():
            got = r[f"mu/{p}"]
            block = tuple(slice(o, o + n) for o, n in
                          zip(r[f"mu/{p}/offs"], got.shape))
            ref = full.numpy()[block]
            np.testing.assert_allclose(got, ref, rtol=1e-5,
                                       atol=1e-6 * np.abs(full.numpy()).max(),
                                       err_msg=p)


def test_seal_ok_on_every_rank_and_state_keeps_its_placements(runs):
    _, _, ranks = runs
    for r in ranks:
        assert bool(r["unseal_ok"])
        for name in ("step", "lr0"):
            assert bool(r[f"{name}/seal_ok"])
            assert bool(r[f"{name}/placements"])


def test_lr0_blocks_equal_one_process_bit_for_bit(runs):
    """Each rank's block of every new params ct and tags leaf is the same
    block of the one-process step's: the same plaintext under nonce+1."""
    _, one, ranks = runs
    want = _paths(one["lr0"][0].params)
    n_split = 0
    for r in ranks:
        for p, st in want.items():
            for f in ("ct", "tags"):
                full = getattr(st, f).numpy()
                got = r[f"lr0/{p}/{f}"]
                offs = r[f"lr0/{p}/{f}/offs"]
                block = tuple(slice(o, o + n)
                              for o, n in zip(offs, got.shape))
                np.testing.assert_array_equal(got, full[block], err_msg=p)
                n_split += got.size < full.size
    assert n_split > 0


def test_one_bit_on_one_rank_poisons_every_rank(runs):
    _, _, ranks = runs
    for r in ranks:
        assert not bool(r["tamper/seal_ok"])
        assert bool(r["tamper/poisoned"])


def test_each_rank_holds_only_its_blocks(runs):
    _, _, ranks = runs
    for r in ranks:
        assert int(r["n_split"]) > 0
        assert 0 < int(r["held"]) < int(r["whole"])
    # the blocks of the 4 x 2 mesh's eight ranks hold each word once per
    # replica: less than the whole state on any one rank
    assert sum(int(r["held"]) for r in ranks) < N_RANKS * int(
        ranks[0]["whole"])


def test_in_place_step_on_blocks_equals_the_default(runs):
    _, _, ranks = runs
    assert all(bool(r["in_place_equal"]) for r in ranks)


def test_seal_of_blocks_equals_the_restored_blocks(runs):
    _, _, ranks = runs
    assert all(bool(r["reseal_equal"]) for r in ranks)


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("col0", [0, 1, 2, 3, 4, 6, 9])
def test_ctr_column_offset_is_the_slice_of_whole_rows(dtype, col0):
    g = torch.Generator().manual_seed(col0)
    x = torch.randint(-2**15, 2**15 - 1, (2, 5, 23), generator=g).to(dtype)
    tkeys = torch.randint(-2**31, 2**31 - 1, (2, 2), generator=g,
                          dtype=torch.int64).to(torch.int32)
    rows = torch.randint(0, 1 << 20, (2, 5), generator=g).to(torch.int32)
    whole = ctr_xor(x, tkeys, rows)
    part = ctr_xor(x[..., col0:].contiguous(), tkeys, rows, col0)
    assert torch.equal(part, whole[..., col0:])


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_reposition_moves_tags_of_a_block_to_its_place(dtype):
    """The tags of a block's own chunks (rows 2.., columns from chunk 2 of
    4), taken as a lattice of their own and repositioned, are the slice of
    the whole tensor's tags; the whole rows' tags of a row block likewise."""
    key = torch.tensor([11, 22], dtype=torch.int32)
    g = torch.Generator().manual_seed(2)
    ct = torch.randint(-2**15, 2**15 - 1, (3, 4, 64), generator=g).to(dtype)
    per = 64 // 4                                 # elements a chunk
    cw = per * ct.element_size() // 4
    whole = mac.block_tags(ct, key, cw)                      # [3, 4, 4]
    keys = mac.mac_keys(key, cw)
    block = ct[:, 2:, 2 * per:].reshape(1, -1, 2 * per).contiguous()
    got = mac_tags(block, keys[None])[0]                     # [6, 2]
    rows = (torch.arange(3)[:, None] * 4 + torch.arange(2, 4)).reshape(-1)
    here = torch.arange(6)[:, None] * 2 + torch.arange(2)
    there = rows[:, None] * 4 + 2 + torch.arange(2)
    moved = mac.reposition(got, keys[0], here, there)
    assert torch.equal(moved.reshape(3, 2, 2), whole[:, 2:, 2:])
    assert not torch.equal(got.reshape(3, 2, 2), whole[:, 2:, 2:])
    full = mac_tags(ct[:, 2:].reshape(1, -1, 64).contiguous(), keys[None])[0]
    moved = mac.reposition(full, keys[0], torch.arange(6)[:, None] * 4
                           + torch.arange(4), rows[:, None] * 4
                           + torch.arange(4))
    assert torch.equal(moved.reshape(3, 2, 4), whole[:, 2:])


def test_byte_lattice_column_offset_is_a_whole_word():
    key = torch.tensor([11, 22], dtype=torch.int32)
    with pytest.raises(ValueError):
        cipher.seal_bits_slice(torch.zeros(2, 4, dtype=torch.uint8), key, 0,
                               torch.arange(2), col0=2)
