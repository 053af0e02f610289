"""Sealed prefill and decode on a sharded state (``launch/steps.py``'s
``make_prefill_fn`` / ``make_decode_fn`` on DTensor leaves) against one
process and the reference.

The counterpart of the reference's dry-run serving cells
(``repro.launch.dryrun``: ``jax.jit(make_prefill_fn / make_decode_fn,
in_shardings=...)``).  Four gloo processes on a (2, 2) ``make_smoke_mesh``
seal their blocks of each family's SMOKE parameters
(``params_shardings``), take a batch of four prompts in
``batch_shardings`` blocks and run a prefill and two greedy decode steps
under ``shd.use(shd.make_ctx(mesh))``; this process runs the same cell on
the whole sealed tree:

* logits and greedy tokens are one process's, bit for bit, on every rank;
* each rank's block of the decode state (ciphertext; plaintext with
  security off, the cell run a second time so) is the same block of one
  process's state, bit for bit;
* a flipped ciphertext bit in one rank's block of a parameter leaf gives
  NaN logits on every rank;
* the collectives each call made (calls and bytes) are the ones the dry
  run (``launch/dryrun.py``) counts for the same cut cells on the meta
  device, in a fake process group of four ranks.

granite-3-2b's SMOKE config (float32) is also run by the reference's own
sharded ``jax.jit`` cells on a (2, 2) mesh of four host devices (Auto
axes) from the same weights and prompts, with security off: its sealed
prefill takes minutes to compile on the CPU, and the port's crypto is
held bit for bit through its one-process cache, which existing tests hold
to the reference's.  Logits within 1e-4, tokens equal.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_dist  # noqa: E402
from repro_torch.core import sealed as sealed_lib  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402

torch.set_num_threads(1)

# one SMOKE config of each family: dense, VLM, MoE, RWKV, hybrid, enc-dec
ARCHS = ("granite-3-2b", "internvl2-2b", "moonshot-v1-16b-a3b", "rwkv6-3b",
         "zamba2-1.2b", "seamless-m4t-large-v2")
N_RANKS, B, S, N_DECODE = 4, 4, 12, 2
TAMPER_RANK = 3
LOGIT_TOL = 1e-4


def _cell(arch, security="trusted"):
    """The prefill_32k cell of ``arch``'s SMOKE config on the CPU, cut to
    B prompts of S tokens and a cache with room for the decode steps."""
    cell = steps.make_cell(arch, "prefill_32k", smoke=True, device="cpu",
                           security=security)
    n_front = (cell.cfg.n_frontend_tokens if cell.cfg.frontend == "patch"
               else 0)
    cell.shape = dataclasses.replace(cell.shape, global_batch=B,
                                     seq_len=n_front + S + N_DECODE + 2)
    return cell


def _inputs(arch):
    """The weights (the port's init) and the prompts of ``arch``."""
    cell = _cell(arch)
    params = cell.model.init(torch.Generator().manual_seed(0), cell.cfg,
                             "cpu")
    rng = np.random.RandomState(1)
    batch = {"tokens": torch.from_numpy(
        rng.randint(0, cell.cfg.vocab, (B, S)).astype(np.int32))}
    for k, shape in steps.batch_extra(cell.cfg, S).items():
        # the frontend inputs in their input_specs dtype, bf16
        batch[k] = torch.from_numpy(
            rng.standard_normal((B, *shape)).astype(np.float32)).to(
                torch.bfloat16)
    return params, batch


def _serve(cell, params, batch, tokens_of=lambda t: t):
    """Prefill and N_DECODE greedy steps: [(logits, state, collectives)]
    per call (the states as they were returned, before the next call
    writes into them; the collectives the call made)."""
    prefill, decode = steps.make_prefill_fn(cell), steps.make_decode_fn(cell)
    with dryrun.CollectiveCount() as coll:
        logits, state = prefill(params, batch)
    out = [(logits, _snapshot(state), coll.stats)]
    for _ in range(N_DECODE):
        tok = logits.argmax(-1).to(torch.int32)
        with dryrun.CollectiveCount() as coll:
            logits, state = decode(params, state, tokens_of(tok))
        out.append((logits, _snapshot(state), coll.stats))
    return out


def _snapshot(state):
    return {k: (v.to_local().clone(), v) if hasattr(v, "to_local")
            else (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


def _rank(rank, port, out_dir, archs):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel import sharding as shd

    torch_dist.init_gloo(rank, port, N_RANKS)
    try:
        mesh = make_smoke_mesh(N_RANKS, device_type="cpu")      # (2, 2)
        coord = mesh.get_coordinate()
        res = {}
        for arch in archs:
            cell = _cell(arch)
            params, batch = _inputs(arch)
            psh = steps.params_shardings(cell, mesh)
            leaves = [shd.distribute(x, s.ct) for x, s in zip(
                sealed_lib.tree_leaves(params),
                sealed_lib.tree_leaves(psh))]
            plain = sealed_lib.tree_unflatten(params, leaves)
            sealed = sealed_lib.seal_tree(plain, cell.key, cell.sec.weights,
                                          1 << 8)
            bsh = steps.batch_shardings(
                cell, mesh, {k: (tuple(v.shape), v.dtype)
                             for k, v in batch.items()}, stacked=False)
            dbatch = {k: shd.distribute(v, bsh[k]) for k, v in batch.items()}
            tok_sh = steps.batch_shardings(
                cell, mesh, {"tokens": ((B,), torch.int32)},
                stacked=False)["tokens"]
            with shd.use(shd.make_ctx(mesh)):
                for name, c, p in ((arch, cell, sealed),
                                   (f"{arch}/off", _cell(arch, "off"),
                                    plain)):
                    calls = _serve(c, p, dbatch,
                                   lambda t: shd.distribute(t, tok_sh))
                    for i, (logits, state, coll) in enumerate(calls):
                        res[f"{name}/{i}/logits"] = logits.numpy()
                        res[f"{name}/{i}/collectives"] = json.dumps(coll)
                        for k, v in state.items():
                            if isinstance(v, tuple):
                                local, d = v
                                offs, _ = sealed_lib.block_of(
                                    tuple(d.shape), mesh, d.placements,
                                    coord)
                                res[f"{name}/{i}/state/{k}"] = local.numpy()
                                res[f"{name}/{i}/state/{k}/offs"] = \
                                    np.asarray(offs)
                # one flipped bit in one rank's block of the first leaf
                # split over both mesh dims
                st = next(x for x in sealed_lib.tree_leaves(sealed)
                          if 4 * x.ct.to_local().numel() == x.ct.numel())
                split = True
                if rank == TAMPER_RANK:
                    st.ct.to_local().view(-1)[0] ^= 1
                logits, _ = steps.make_prefill_fn(cell)(sealed, dbatch)
                res[f"{arch}/tamper/split"] = split
                res[f"{arch}/tamper/nan"] = bool(torch.isnan(logits).all())
        dist.barrier()
        np.savez(f"{out_dir}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


REFERENCE = r"""
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.launch import steps
from repro.parallel import sharding as shd

z = np.load(%r)
tree = {}
for path, v in z.items():
    node, (*head, last) = tree, path.split("/")
    for k in head:
        node = node.setdefault(k, {})
    node[last] = jnp.asarray(v)
params, batch = tree["params"], tree["batch"]
cell = steps.make_cell("granite-3-2b", "prefill_32k", smoke=True,
                       security="off")
cell.shape = dataclasses.replace(cell.shape, global_batch=%d, seq_len=%d)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
with shd.use(shd.make_ctx(mesh)):
    p_sh = steps.params_shardings(cell, mesh)
    bspecs = configs.input_specs(cell.cfg, cell.shape)
    b_sh = steps.batch_shardings(cell, mesh, bspecs, stacked=False)
    c_sh = steps.decode_state_shardings(cell, mesh)
    prefill = jax.jit(steps.make_prefill_fn(cell), in_shardings=(p_sh, b_sh))
    t_sh = steps.batch_shardings(
        cell, mesh, {"tokens": jax.ShapeDtypeStruct((%d,), jnp.int32)},
        stacked=False)["tokens"]
    decode = jax.jit(steps.make_decode_fn(cell),
                     in_shardings=(p_sh, c_sh, t_sh),
                     out_shardings=(None, c_sh))
    logits, cache = prefill(params, batch)
    cache = jax.device_put(cache, c_sh)
    out = {"logits0": np.asarray(logits)}
    for i in range(%d):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = decode(params, cache, tok)
        out[f"logits{i + 1}"] = np.asarray(logits)
np.savez(%r, **out)
"""


def _start_reference(code: str, n_devices: int):
    """``torch_dist.reference``'s subprocess, started and left running
    (the port's runs go on meanwhile)."""
    import os
    import subprocess
    import sys
    import textwrap

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}",
               PYTHONPATH=str(torch_dist.ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_serve")
    # granite's weights and prompts for the reference's sharded jit cells
    params, batch = _inputs("granite-3-2b")
    np.savez(out / "granite.npz", **{
        f"params/{k}": v.numpy()
        for k, v in torch_dist.flat(params).items()},
        **{f"batch/{k}": v.numpy() for k, v in batch.items()})
    cell = _cell("granite-3-2b")
    ref = _start_reference(
        REFERENCE % (str(out / "granite.npz"), B, cell.shape.seq_len, B,
                     N_DECODE, str(out / "ref.npz")), n_devices=4)
    one = {}
    for arch in ARCHS:
        cell = _cell(arch)
        params, batch = _inputs(arch)
        sealed = sealed_lib.seal_tree(params, cell.key, cell.sec.weights,
                                      1 << 8)
        one[arch] = _serve(cell, sealed, batch)
        one[f"{arch}/off"] = _serve(_cell(arch, "off"), params, batch)
    torch_dist.spawn(_rank, N_RANKS, out, ARCHS, timeout=240)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(N_RANKS)]
    stdout, stderr = ref.communicate(timeout=300)
    assert ref.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    return one, ranks, dict(np.load(out / "ref.npz"))


SECURED = [pytest.param(a, id=a) for a in ARCHS] + [
    pytest.param(f"{a}/off", id=f"{a}-security-off") for a in ARCHS]


@pytest.mark.parametrize("arch", SECURED)
def test_logits_and_tokens_are_one_process_bit_for_bit(runs, arch):
    one, ranks, _ = runs
    for r in ranks:
        for i, (logits, _, _) in enumerate(one[arch]):
            got = r[f"{arch}/{i}/logits"]
            want = logits.numpy()
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
                (arch, i, np.abs(got - want).max())
            assert np.isfinite(got).all()
            assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", SECURED)
def test_each_rank_holds_its_block_of_one_process_state(runs, arch):
    """Each rank's block of every field of the decode state (ciphertext;
    plaintext with security off), after the prefill and after each decode
    step, is that block of one process's, bit for bit; some fields are
    split (a rank holds less than all)."""
    one, ranks, _ = runs
    n_split = 0
    for r in ranks:
        for i, (_, state, _) in enumerate(one[arch]):
            fields = [k for k in state if f"{arch}/{i}/state/{k}" in r]
            assert fields
            for k in fields:
                got = r[f"{arch}/{i}/state/{k}"]
                offs = r[f"{arch}/{i}/state/{k}/offs"]
                full = state[k].numpy()
                block = full[tuple(slice(o, o + n)
                                   for o, n in zip(offs, got.shape))]
                np.testing.assert_array_equal(got, block,
                                              err_msg=f"{arch} {i} {k}")
                n_split += got.size < full.size
    assert n_split > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_flipped_bit_in_one_rank_block_poisons_every_rank(runs, arch):
    _, ranks, _ = runs
    for r in ranks:
        assert bool(r[f"{arch}/tamper/split"])
        assert bool(r[f"{arch}/tamper/nan"])


def test_granite_matches_the_reference_sharded_jit(runs):
    one, ranks, ref = runs
    for i in range(N_DECODE + 1):
        want = ref[f"logits{i}"]
        for r in ranks:
            got = r[f"granite-3-2b/{i}/logits"]
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
            assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_are_the_dry_run_counts(runs, arch):
    from repro_torch.launch.mesh import make_smoke_mesh
    _, ranks, _ = runs
    cfg = _cell(arch).cfg                         # the SMOKE config
    smoke = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    cuts = {"seq_len": _cell(arch).shape.seq_len, "global_batch": B}
    with dryrun.fake_world(N_RANKS):
        mesh = make_smoke_mesh(N_RANKS, device_type="cpu")
        rows = [dryrun.run_cell(arch, shape, mesh, "smoke_2x2", "trusted",
                                overrides=smoke, cuts=cuts, prompt_len=S)
                for shape in ("prefill_32k", "decode_32k")]
    assert all(r["status"] == "ok" for r in rows)
    for r in ranks:
        for i in range(N_DECODE + 1):
            got = json.loads(str(r[f"{arch}/{i}/collectives"]))
            assert got == rows[min(i, 1)]["collectives"], (arch, i)
