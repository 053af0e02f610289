"""Multi-mesh dry run (torch port of ``repro.launch.dryrun``).

For every (architecture x input-shape) cell, RUN the real step callable
(``make_train_step_fn`` / ``make_prefill_fn`` / ``make_decode_fn``) on
tensors of the meta device, laid out as one rank's blocks of the states in
their shardings (``train_state_shardings``, ``params_shardings``,
``decode_state_shardings``, ``batch_shardings``), on the production
meshes of H100 nodes (``launch/mesh.py::make_production_mesh``):

    32x8      ("data", "model")          256 cards, 32 nodes of 8
    2x32x8    ("pod", "data", "model")   512 cards in two pods

The calls are made under ``shd.use(shd.make_ctx(mesh))`` as rank 0 of a
process group of torch's ``fake`` backend at the mesh's world size: every
collective returns at once, and the meta tensors carry shapes and dtypes
only.  A cell that runs proves that its step runs on the mesh, as the
reference's compile does.  Each row records, for one rank:

* ``args_bytes_per_device``: the bytes of the step's arguments on the
  rank, from the shardings' local shapes (the reference's
  ``_tree_device_bytes``);
* ``peak_bytes_per_device``: the peak of the bytes the rank holds over the
  run, its arguments included (``Tally``, as
  ``torch.distributed._tools.mem_tracker`` counts them), in place of XLA's
  ``memory_analysis``;
* ``flops``: the FLOPs of the matmuls, the attention and RWKV-6's and
  Mamba-2's scans (``Tally``, by ``torch.utils.flop_counter``'s formulas
  and the formulas the scan ops and the fused attention's ops register,
  ``kernels/*_scan/ops.py``, ``kernels/flash_attention/ops.py``), the
  scans over every token, bf16 causal attention over the (query, key)
  pairs its mask keeps, as the card's kernels run it;
* ``collectives``: ``{op: {count, bytes}}`` of the collectives the port
  calls (bytes of each call's output), under the reference's HLO names,
  and ``collective_link_bytes`` by the reference's ring formula;
* ``ctr_launches`` / ``mac_launches``: the CTR and MAC kernel launches the
  card would make (the wrappers' ``meta_launches``).

The reference's ``hlo_collectives`` (the compiled collective schedule) has
no counterpart: the port runs eagerly and these are its calls.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --security trusted \\
        --out results/dryrun_torch.jsonl

Importing the module touches no process group: each cell runs in a fake
group of its own (its world is fixed when it opens), in a process of its
own when there are several cells, as many at once as the machine has
cores.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from .. import configs
from ..core import sealed as sealed_lib
from ..kernels.ctr_cipher import ops as ctr_ops
from ..kernels.tree_mac import ops as mac_ops
from ..models import registry
from ..optim import TrainState
from ..parallel import sharding as shd
from . import steps
from .mesh import make_production_mesh

DEFAULT_OUT = "results/dryrun_torch.jsonl"
FLOPS_COUNTED = ("matmul, attention (the fused causal kernels over the pairs "
                 "they keep) and the RWKV-6 / Mamba-2 scans")

# torch.distributed's collectives the port calls -> the reference's HLO names
_HLO_NAMES = {"all_gather_into_tensor": "all-gather",
              "all_reduce": "all-reduce",
              "reduce_scatter_tensor": "reduce-scatter",
              "all_to_all_single": "all-to-all"}

# --mesh's production meshes: (ranks, multi_pod, the rows' name)
MESHES = {"pod": (256, False, "pod_32x8"),
          "multipod": (512, True, "multipod_2x32x8")}

# a scalar leaf the reference holds as a 4-byte array (a SealedTensor's
# nonce, a decode state's pos and nonce); the port holds a Python int
_SCALAR_BYTES = 4


def collective_link_bytes(colls: dict) -> float:
    """Approx bytes crossing a device's links (ring algorithms)."""
    total = 0.0
    for op, rec in colls.items():
        factor = 2.0 if op == "all-reduce" else 1.0
        total += factor * rec["bytes"]
    return total


class CollectiveCount:
    """Calls and output bytes of each collective of ``torch.distributed``
    the port makes while installed: ``{hlo name: {count, bytes}}``."""

    def __init__(self):
        self.stats = {}

    def __enter__(self):
        self.saved = {n: getattr(dist, n) for n in _HLO_NAMES}
        for n, fn in self.saved.items():
            setattr(dist, n, self._counted(_HLO_NAMES[n], fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(dist, n, fn)

    def _counted(self, name, fn):
        def call(out, *args, **kwargs):
            rec = self.stats.setdefault(name, {"count": 0, "bytes": 0.0})
            rec["count"] += 1
            rec["bytes"] += float(out.numel() * out.element_size())
            return self._call(rec, fn, out, *args, **kwargs)
        return call

    def _call(self, rec, fn, *args, **kwargs):
        """One collective call; ``rec`` is its op's record."""
        return fn(*args, **kwargs)


class Tally(TorchDispatchMode):
    """While active: the FLOPs of the matmul, attention and scan ops (the
    formulas in ``torch.utils.flop_counter``'s registry) and the bytes of
    the meta storages alive, with their peak.  A storage counts from the
    op that makes it until it is freed; ``hold`` counts tensors made
    before (the step's arguments).  One dispatch mode in place of
    ``FlopCounterMode`` and ``mem_tracker.MemTracker``, with the same
    FLOPs and peak (``tools/dryrun_tally.py`` compares them on a cell) in
    about half their time."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def hold(self, tensors) -> None:
        for t in tensors:
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a ``fake`` process group of ``n`` ranks:
    collectives return at once without moving data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# a rank's blocks of an abstract (meta) tree
# ---------------------------------------------------------------------------

def _block(x: torch.Tensor, sh) -> DTensor:
    size, _ = compute_local_shape_and_global_offset(x.shape, sh.mesh,
                                                    sh.placements)
    return sealed_lib.wrap(torch.empty(size, dtype=x.dtype, device="meta"),
                           sh.mesh, sh.placements, x.shape)


def blocks(tree, shardings):
    """``tree`` (meta tensors of whole shapes) as this rank's blocks: a
    DTensor of meta tensors per tensor leaf, in its sharding."""
    if isinstance(tree, sealed_lib.SealedTensor):
        return sealed_lib.SealedTensor(_block(tree.ct, shardings.ct),
                                       _block(tree.tags, shardings.tags),
                                       tree.nonce, tree.dtype, tree.spec)
    if isinstance(tree, TrainState):
        return TrainState(**{f.name: blocks(getattr(tree, f.name),
                                            getattr(shardings, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: blocks(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _block(tree, shardings)
    return tree


def _locals(tree) -> list:
    """The local tensors of a tree of blocks."""
    out = []
    for leaf in sealed_lib.tree_leaves(tree):
        if isinstance(leaf, TrainState):
            out += _locals([leaf.step, leaf.params, leaf.mu, leaf.nu])
        elif sealed_lib.is_sealed(leaf):
            out += [leaf.ct.to_local(), leaf.tags.to_local()]
        elif isinstance(leaf, DTensor):
            out.append(leaf.to_local())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _tree_device_bytes(tree) -> float:
    """Bytes a rank holds of a tree of blocks: every local tensor, and 4
    for each scalar the reference holds as an array (a SealedTensor's
    nonce, a decode state's ``pos`` and ``nonce``)."""
    n = sum(t.numel() * t.element_size() for t in _locals(tree))
    for leaf in sealed_lib.tree_leaves(tree):
        if isinstance(leaf, TrainState):
            leaf = [leaf.params, leaf.mu, leaf.nu]
        n += _SCALAR_BYTES * sum(
            1 for x in sealed_lib.tree_leaves(leaf)
            if sealed_lib.is_sealed(x) or isinstance(x, int))
    return float(n)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _batch_blocks(cell, mesh, specs: dict, stacked: bool) -> dict:
    sh = steps.batch_shardings(cell, mesh, specs, stacked=stacked)
    return {k: _block(torch.empty(shape, dtype=dt, device="meta"), sh[k])
            for k, (shape, dt) in specs.items()}


def cell_inputs(cell, mesh, microbatch: int = 0, prompt_len: int = 0):
    """(step callable, its arguments as this rank's meta blocks, extra row
    fields) of one cell on ``mesh``.  ``prompt_len`` cuts a serving
    cell's prompts (and the encoder-decoder's source) below its
    ``seq_len`` slots."""
    kind = cell.shape.kind
    if kind == "train":
        mb = microbatch or configs.train_microbatch(cell.arch_id)
        n_accum = cell.shape.global_batch // mb
        ast = steps.abstract_train_state(cell)
        state = blocks(ast, steps.train_state_shardings(cell, mesh, ast))
        batch = _batch_blocks(cell, mesh, steps.stacked_batch_specs(
            cell, n_accum, mb), stacked=True)
        return (steps.make_train_step_fn(cell), (state, batch),
                {"n_accum": n_accum, "microbatch": mb})
    ap = steps.abstract_params(cell)
    params = blocks(ap, steps.params_shardings(cell, mesh, ap))
    specs = configs.input_specs(cell.cfg, cell.shape)
    if prompt_len and kind == "prefill":
        specs = {k: ((s[0], prompt_len, *s[2:])
                     if k in ("tokens", "frame_embeds") else s, dt)
                 for k, (s, dt) in specs.items()}
    batch = _batch_blocks(cell, mesh, specs, stacked=False)
    if kind == "prefill":
        return steps.make_prefill_fn(cell), (params, batch), {}
    ac = steps.abstract_decode_state(cell)
    if prompt_len and cell.cfg.family == "encdec":
        ac = registry.make_decode_state(
            cell.cfg, cell.shape.global_batch, cell.shape.seq_len,
            prompt_len, sealed=cell.sealed, device="meta")
    state = blocks(ac, steps.decode_state_shardings(cell, mesh, ac))
    return steps.make_decode_fn(cell), (params, state, batch["tokens"]), {}


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             security: str, overrides: dict | None = None,
             microbatch: int = 0, cuts: dict | None = None,
             prompt_len: int = 0) -> dict:
    """One cell's row.  ``cuts`` ({"seq_len": ..., "global_batch": ...})
    cuts the shape and ``prompt_len`` a serving cell's prompts: the cells
    that run for real on the card, whose counts the row must equal."""
    t0 = time.time()
    cell = steps.make_cell(arch, shape_name, security=security,
                           overrides=overrides, device="meta")
    if cuts:
        cell.shape = dataclasses.replace(cell.shape, **cuts)
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "security": security, "kind": cell.shape.kind}
    skip = configs.skip_reason(arch, shape_name)
    if skip:
        row.update(status="skip", reason=skip)
        return row
    with shd.use(shd.make_ctx(mesh)):
        fn, args, extra = cell_inputs(cell, mesh, microbatch, prompt_len)
        row.update(extra)
        row["args_bytes_per_device"] = _tree_device_bytes(args)
        c0 = ctr_ops.ctr_xor.meta_launches
        m0 = mac_ops.mac_tags.meta_launches
        with CollectiveCount() as coll, Tally() as tally:
            tally.hold(_locals(args))
            out = fn(*args)
            del out
    row["peak_bytes_per_device"] = float(tally.peak)
    row["flops"] = float(tally.flops)
    row["flops_counted"] = FLOPS_COUNTED
    row["collectives"] = coll.stats
    row["collective_link_bytes"] = collective_link_bytes(coll.stats)
    row["ctr_launches"] = ctr_ops.ctr_xor.meta_launches - c0
    row["mac_launches"] = mac_ops.mac_tags.meta_launches - m0
    row["status"] = "ok"
    row["trace_s"] = round(time.time() - t0, 1)
    return row


def run_task(task: tuple) -> dict:
    """One cell on one production mesh, in a fake group of its own:
    ``(arch, shape, "pod" | "multipod", security)`` -> its row (a failure
    is a row too)."""
    arch, shape, which, security = task
    n, multi_pod, name = MESHES[which]
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        try:
            return run_cell(arch, shape, mesh, name, security)
        except Exception as e:
            return {"arch": arch, "shape": shape, "mesh": name,
                    "security": security, "status": "fail",
                    "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=("pod", "multipod", "both"))
    ap.add_argument("--security", default="trusted",
                    choices=("trusted", "ctr", "off"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already ok/skip in --out")
    args = ap.parse_args()

    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") in ("ok", "skip"):
                    done.add((r["arch"], r["shape"], r["mesh"], r["security"]))

    if args.all:
        cells = [(a, s.name) for a, s, _ in configs.all_cells()]
    else:
        assert args.arch and args.shape
        cells = [(args.arch, args.shape)]
    tasks = [(arch, shape, which, args.security)
             for which in MESHES if args.mesh in (which, "both")
             for arch, shape in cells
             if (arch, shape, MESHES[which][2], args.security) not in done]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_ok = n_skip = n_fail = 0
    with contextlib.ExitStack() as stack:
        out_f = stack.enter_context(open(args.out, "a"))
        jobs = min(len(tasks), os.cpu_count() or 1)
        if jobs > 1:
            # a cell a process, as many at once as the machine has cores
            import multiprocessing
            pool = stack.enter_context(multiprocessing.get_context(
                "spawn").Pool(jobs, maxtasksperchild=1))
            rows = pool.imap(run_task, tasks)
        else:
            rows = map(run_task, tasks)
        for row in rows:
            st = row["status"]
            n_ok += st == "ok"
            n_skip += st == "skip"
            n_fail += st == "fail"
            msg = {"ok": f"flops={row.get('flops', 0):.3e} "
                         f"coll={row.get('collective_link_bytes', 0):.3e}B "
                         f"peak={row.get('peak_bytes_per_device', 0):.3e}B "
                         f"({row.get('trace_s', 0)}s)",
                   "skip": row.get("reason", ""),
                   "fail": row.get("error", "")}[st]
            print(f"[{st:4s}] {row['mesh']:18s} {row['arch']:26s} "
                  f"{row['shape']:12s} {msg}", flush=True)
            slim = {k: v for k, v in row.items() if k != "trace"}
            out_f.write(json.dumps(slim) + "\n")
            out_f.flush()
    print(f"\nDRY-RUN SUMMARY: ok={n_ok} skip={n_skip} fail={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
