"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

* ``args_bytes_per_device`` equals the reference's ``_tree_device_bytes``
  byte for byte on a (16, 16) and a (32, 8) mesh of 256 ranks, for one
  config of each family and each shape kind (train, prefill, decode);
  the reference's numbers come from subprocesses with 256 host devices,
  the port's from a fake process group of 256 ranks in this process;
* skip rows equal the reference's for all 40 cells, and
  ``collective_link_bytes`` is the reference's formula;
* granite-3-2b's three shapes run ``ok`` at full size on the production
  pod mesh (32 x 8) through the command line, and the dense prefill's
  FLOPs are within 1% of the count from the config's shapes;
* ``--resume`` skips the rows already in ``--out``;
* ``Tally`` counts the FLOPs and the peak as torch's ``FlopCounterMode``
  and ``MemTracker`` do;
* RWKV-6's and Zamba2's rows count their scans over every token: no row
  is flagged a lower bound;
* the CTR and MAC wrappers' meta path gives empty results of the right
  shapes and counts the launches the card would make in ``meta_launches``,
  never in ``launches``.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

import torch_dist  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.ctr_cipher import ops as ctr_ops  # noqa: E402
from repro_torch.kernels.tree_mac import ops as mac_ops  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402

FAMILY_ARCHS = ("granite-3-2b", "internvl2-2b", "moonshot-v1-16b-a3b",
                "rwkv6-3b", "zamba2-1.2b", "seamless-m4t-large-v2")
KIND_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESHES = {"16x16": (16, 16), "32x8": (32, 8)}
GRANITE = "granite-3-2b"
FLOPS_RTOL = 0.01

REFERENCE = r"""
import json
import numpy as np, jax
from jax.sharding import Mesh
from repro import configs
from repro.launch import steps, dryrun
devs = np.array(jax.devices()[:256])
meshes = {name: Mesh(devs.reshape(shape), ("data", "model"))
          for name, shape in %r.items()}
out = {}
for arch in %r:
    for shape in %r:
        cell = steps.make_cell(arch, shape)
        if cell.shape.kind == "train":
            mb = configs.train_microbatch(arch)
            n = cell.shape.global_batch // mb
            trees = [steps.abstract_train_state(cell)]
            b = steps.stacked_batch_specs(cell, n, mb)
        else:
            trees = [steps.abstract_params(cell)]
            b = configs.input_specs(cell.cfg, cell.shape)
            if cell.shape.kind == "decode":
                trees.append(steps.abstract_decode_state(cell))
        for name, mesh in meshes.items():
            if cell.shape.kind == "train":
                shs = [steps.train_state_shardings(cell, mesh, trees[0])]
            else:
                shs = [steps.params_shardings(cell, mesh, trees[0])]
                if cell.shape.kind == "decode":
                    shs.append(steps.decode_state_shardings(cell, mesh,
                                                            trees[1]))
            bsh = steps.batch_shardings(cell, mesh, b,
                                        stacked=cell.shape.kind == "train")
            out[f"{arch}/{shape}/{name}"] = sum(
                dryrun._tree_device_bytes(t, s, mesh)
                for t, s in zip(trees + [b], shs + [bsh]))
print(json.dumps(out))
"""


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(torch_dist.ROOT / "src"), **extra)


def _popen(args, **env):
    return subprocess.Popen(args, env=_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=str(torch_dist.ROOT))


def _done(proc, timeout):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, \
        f"STDOUT:\n{out[-4000:]}\nSTDERR:\n{err[-4000:]}"
    return out


@pytest.fixture(scope="module")
def granite_rows(tmp_path_factory):
    """granite-3-2b's three shapes on the pod mesh, through the command
    line, one process each (they run while the other tests do)."""
    out = tmp_path_factory.mktemp("dryrun")
    procs = {s: _popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", GRANITE, "--shape", s, "--out",
                        str(out / f"{s}.jsonl")]) for s in KIND_SHAPES}
    return procs, out, {}


@pytest.fixture(scope="module")
def reference_bytes():
    """{arch/shape/mesh: bytes} from the reference, two families a
    process."""
    procs = [_popen([sys.executable, "-c", textwrap.dedent(
        REFERENCE % (MESHES, list(FAMILY_ARCHS[i:i + 2]), KIND_SHAPES))],
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=256")
        for i in range(0, len(FAMILY_ARCHS), 2)]
    out = {}
    for p in procs:
        out.update(json.loads(_done(p, 600).splitlines()[-1]))
    return out


def test_import_touches_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun\n"
            "assert not dist.is_initialized()\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_args_bytes_equal_the_reference(granite_rows, reference_bytes, arch,
                                        mesh_name):
    with dryrun.fake_world(256):
        mesh = init_device_mesh("cpu", MESHES[mesh_name],
                                mesh_dim_names=("data", "model"))
        for shape in KIND_SHAPES:
            cell = steps.make_cell(arch, shape, device="meta")
            _, args, _ = dryrun.cell_inputs(cell, mesh)
            got = dryrun._tree_device_bytes(args)
            assert got == reference_bytes[f"{arch}/{shape}/{mesh_name}"], \
                (arch, shape, mesh_name)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_skip_rows_equal_the_reference(arch):
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun        # sets XLA_FLAGS
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    from repro import configs as jconfigs
    assert [(a, s.name, r) for a, s, r in configs.all_cells()] == \
        [(a, s.name, r) for a, s, r in jconfigs.all_cells()]
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        skip = configs.skip_reason(arch, shape)
        assert skip == jconfigs.skip_reason(arch, shape)
        if skip:
            args = (arch, shape, None, "pod_32x8", "trusted")
            assert dryrun.run_cell(*args) == jdryrun.run_cell(*args)


def test_collective_link_bytes_is_the_reference_formula():
    from repro.launch.dryrun import collective_link_bytes as ref
    for colls in ({}, {"all-gather": {"count": 3, "bytes": 7.0}},
                  {"all-reduce": {"count": 2, "bytes": 5.5},
                   "all-gather": {"count": 1, "bytes": 2.0},
                   "reduce-scatter": {"count": 1, "bytes": 3.0}}):
        assert dryrun.collective_link_bytes(colls) == ref(colls)


def _rows(granite_rows):
    procs, out, rows = granite_rows
    for s, p in procs.items():
        if s not in rows:
            text = _done(p, 900)
            assert "DRY-RUN SUMMARY: ok=1 skip=0 fail=0" in text, text
            rows[s] = json.loads(
                (out / f"{s}.jsonl").read_text().splitlines()[-1])
    return rows


@pytest.mark.parametrize("shape", KIND_SHAPES)
def test_granite_full_size_cells_run_on_the_pod_mesh(granite_rows, shape):
    row = _rows(granite_rows)[shape]
    assert row["status"] == "ok" and row["mesh"] == "pod_32x8"
    assert row["kind"] == shape.split("_")[0]
    for k in ("args_bytes_per_device", "peak_bytes_per_device", "flops",
              "collective_link_bytes", "ctr_launches", "mac_launches"):
        assert row[k] > 0, k
    assert row["peak_bytes_per_device"] >= row["args_bytes_per_device"]
    # the FSDP-style gather of the parameters, the verdict's all-reduce
    assert set(row["collectives"]) == {"all-gather", "all-reduce"}


def test_dense_prefill_flops_match_the_config(granite_rows):
    """Every rank runs the whole batch: 2 x tokens x the projection and MLP
    weights, plus QK and PV over the whole key range (the blocked
    attention masks, it does not skip), plus the last token's logits."""
    row = _rows(granite_rows)["prefill_32k"]
    cfg = configs.get_config(GRANITE)
    shape = configs.SHAPES_BY_NAME["prefill_32k"]
    B, S, D, hd = shape.global_batch, shape.seq_len, cfg.d_model, cfg.hd
    proj = D * cfg.n_heads * hd * 2 + D * cfg.n_kv_heads * hd * 2
    per_layer = 2 * B * S * (proj + 3 * D * cfg.d_ff) \
        + 4 * B * S * S * cfg.n_heads * hd
    want = cfg.n_layers * per_layer + 2 * B * D * cfg.vocab
    assert abs(row["flops"] - want) <= FLOPS_RTOL * want, (row["flops"], want)


def test_resume_skips_rows_already_done(tmp_path):
    out = tmp_path / "rows.jsonl"
    done = {"arch": GRANITE, "shape": "decode_32k", "mesh": "pod_32x8",
            "security": "trusted", "status": "ok"}
    out.write_text(json.dumps(done) + "\n")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", GRANITE, "--shape", "decode_32k", "--out",
                        str(out), "--resume"], env=_env(),
                       capture_output=True, text=True, timeout=120,
                       cwd=str(torch_dist.ROOT))
    assert r.returncode == 0, r.stderr
    assert "DRY-RUN SUMMARY: ok=0 skip=0 fail=0" in r.stdout
    assert out.read_text() == json.dumps(done) + "\n"


def test_tally_counts_as_torch_counters_do():
    """``dryrun.Tally`` against ``FlopCounterMode`` with ``MemTracker``
    (``tools/dryrun_tally.py``) on granite's full-size decode cell on the
    pod mesh: the same FLOPs, and a peak between MemTracker's meta peak
    and that plus its CPU peak (Tally counts a storage of any device that
    an op makes; MemTracker splits them by device)."""
    spec = importlib.util.spec_from_file_location(
        "dryrun_tally", torch_dist.ROOT / "tools" / "dryrun_tally.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tally = tool.measure(GRANITE, "decode_32k", "tally")
    lib = tool.measure(GRANITE, "decode_32k", "torch")
    assert tally["flops"] == lib["flops"] > 0
    meta, cpu = lib["peak_bytes"]["meta"], lib["peak_bytes"].get("cpu", 0)
    assert meta <= tally["peak_bytes"]["meta"] <= meta + cpu


@pytest.mark.parametrize("arch,shape,scan", [
    ("rwkv6-3b", "prefill_32k", "wkv6"), ("zamba2-1.2b", "prefill_32k", "ssd"),
    ("rwkv6-3b", "decode_32k", "wkv6"), ("granite-3-2b", "prefill_32k",
                                         None)])
def test_rows_of_one_token_recurrences_are_lower_bounds(monkeypatch, arch,
                                                         shape, scan):
    """No row is a lower bound any more: RWKV-6's and Zamba2's recurrences
    run on meta as one scan op over every token, so no row carries
    ``recurrence_tokens_run``, ``flops_is_lower_bound`` or
    ``peak_is_lower_bound``, and a row's FLOPs hold the scan's formula: one
    forward a layer at the cell's batch and length (a decode step's one
    token), counted as one meta launch a layer; a family without a scan
    gains nothing."""
    from torch.utils.flop_counter import flop_registry

    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.wkv6_scan import ops as wkv_ops
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import ssm

    def row_of():
        with dryrun.fake_world(2):
            return dryrun.run_cell(arch, shape, make_smoke_mesh(
                2, device_type="cpu"), "smoke_1x2", "trusted", microbatch=1,
                cuts={"seq_len": 64, "global_batch": 2})

    fwd = {"wkv6": wkv_ops.wkv6_forward, "ssd": ssd_ops.ssd_forward}
    n0 = {k: f.meta_launches for k, f in fwd.items()}
    row = row_of()
    assert row["status"] == "ok"
    assert not {"recurrence_tokens_run", "flops_is_lower_bound",
                "peak_is_lower_bound"} & set(row)
    assert row["flops_counted"] == dryrun.FLOPS_COUNTED
    cfg = configs.get_config(arch)
    B, S = 2, (64 if shape == "prefill_32k" else 1)
    if scan == "wkv6":
        hd = cfg.rwkv.head_dim
        want = wkv_ops.forward_flops(B, S, cfg.d_model // hd, hd)
    elif scan == "ssd":
        _, H, P, N = ssm._m2_dims(cfg)
        want = ssd_ops.forward_flops(B, S, H, P, N)
    else:
        want = 0
    for k, f in fwd.items():
        assert f.meta_launches - n0[k] == (cfg.n_layers if k == scan else 0)
    for op in (torch.ops.repro_torch.wkv6_forward,
               torch.ops.repro_torch.wkv6_backward,
               torch.ops.repro_torch.ssd_forward,
               torch.ops.repro_torch.ssd_backward):
        monkeypatch.delitem(flop_registry, op)
    assert row["flops"] - row_of()["flops"] == cfg.n_layers * want


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_ctr_meta_path_gives_shapes_and_counts_launches(dtype):
    x = torch.empty((3, 5, 7), dtype=dtype, device="meta")
    keys = torch.empty((3, 2), dtype=torch.int32, device="meta")
    rows = torch.empty((3, 5), dtype=torch.int32, device="meta")
    n0, real = ctr_ops.ctr_xor.meta_launches, ctr_ops.ctr_xor.launches
    out = ctr_ops.ctr_xor(x, keys, rows, 3)
    assert out.device.type == "meta" and out.dtype == dtype
    assert tuple(out.shape) == (3, 5, 7)
    assert ctr_ops.ctr_xor.meta_launches == n0 + 1
    ctr_ops.ctr_xor(torch.empty((3, 0, 7), dtype=dtype, device="meta"), keys)
    assert ctr_ops.ctr_xor.meta_launches == n0 + 1     # nothing to launch
    assert ctr_ops.ctr_xor.launches == real            # nothing launched
    with pytest.raises(ValueError):
        ctr_ops.ctr_xor(x, keys[:2])


@pytest.mark.parametrize("limit,launches", [(None, 1), (64, 2 * 2)])
def test_mac_meta_path_gives_shapes_and_counts_slabs(monkeypatch, limit,
                                                     launches):
    """[2, 6, 40] int16 (20 words a row) in chunks of 4 words: 5 tags a
    row; an item of 120 words over a 64-word limit takes slabs of 3 rows,
    2 an item."""
    if limit is not None:
        monkeypatch.setattr(mac_ops, "MAX_ITEM_WORDS", limit)
    x = torch.empty((2, 6, 40), dtype=torch.int16, device="meta")
    keys = torch.empty((2, 4), dtype=torch.int32, device="meta")
    n0, real = mac_ops.mac_tags.meta_launches, mac_ops.mac_tags.launches
    out = mac_ops.mac_tags(x, keys)
    assert out.device.type == "meta" and out.dtype == torch.int32
    assert tuple(out.shape) == (2, 6, 5)
    assert mac_ops.mac_tags.meta_launches == n0 + launches
    assert mac_ops.mac_tags.launches == real           # nothing launched
    assert mac_ops.slab_rows(6, 80) == (6 if limit is None else 3)


def test_unseal_state_host_reads_no_verdict_on_meta():
    """The host check of ``unseal_state_host`` passes a meta state (the
    dry run's), which has no value to read."""
    from repro_torch.train import trainer
    cell = steps.make_cell(GRANITE, "train_4k", smoke=True, device="meta")
    state = trainer.unseal_state_host(steps.abstract_train_state(cell),
                                      cell.key, cell.sec)
    leaf = state.params["embed"]
    assert leaf.device.type == "meta" and leaf.dtype == cell.cfg.p_dtype
    assert not dist.is_initialized()
    assert np.prod(tuple(leaf.shape)) == cell.cfg.vocab * cell.cfg.d_model
