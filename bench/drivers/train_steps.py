"""Sealed training through the port's train step
(``repro_torch.train.make_train_step``, resealing in place), fed by the
traffic file's batches (``traffic.train_batch``).

Set-up builds the kernels, runs the attested handshake, makes the weights
from the seed, seals the state (parameters and AdamW moments) and drives
that one step object through its first ``check_steps`` steps, on the
window's own call and feed.  Those steps are the warm-up and what the
check reads: each step's loss, the first gradient as the optimizer got it
(the first moment after one step over 1 - b1), and the parameters' change
after the last of them.  The window then runs whole steps of the same
object until ``--seconds`` have passed.  The check follows the same steps
with the plain reference and compares, by the worst leaf.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from benchlib import reference, weights, yardstick
from benchlib.cell import port_config
from benchlib.harness import Check, setup_part
from benchlib.sizes import sizes_of
from benchlib.profiling import span, traced
from benchlib.traffic import train_batch


def make(cell, ctx):
    return Train(cell, ctx)


def leaf_paths(tree, prefix=()) -> list:
    """Leaf paths in the port's tree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                            prefix + (k,))]
    return [prefix]


class Train:
    def __init__(self, cell, ctx):
        self.cell, self.ctx, self.t = cell, ctx, cell.traffic
        self.cfg = port_config(cell.config, smoke=ctx.smoke)
        self.sz = sizes_of(cell.config, smoke=ctx.smoke)
        self.check_s = 0.0
        self.setup_parts: dict = {}
        self.failed = 0
        self.tok_per_step = (self.t["microbatches"] * self.t["batch"]
                             * self.t["seq_len"])

    def batch(self, i: int) -> dict:
        b = train_batch(self.t, self.ctx.seed, i, self.sz.vocab)
        return {k: torch.as_tensor(v, device=self.ctx.device)
                for k, v in b.items()}

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        ctx, cfg = self.ctx, self.cfg

        def part(name):
            return setup_part(self.setup_parts, name, ctx.device)

        with part("imports"):
            from repro_torch import configs
            from repro_torch.core.channel import SecureChannel
            from repro_torch.kernels import build
            from repro_torch.models import registry
            from repro_torch.optim import AdamW
            from repro_torch.train import trainer
        if ctx.device != "cpu":
            with part("build"):
                build.build_all()
        with part("handshake"):
            channel = SecureChannel.establish(device=ctx.device)
        self.key, sec = channel.jkey, channel.config
        arch = self.cell.config["arch_id"]
        opt = AdamW(lr=self.t["lr"],
                    state_dtype=configs.opt_state_dtype(arch))
        self.opt = opt
        with part("weights"):
            params = weights.make_tree(self.sz, ctx.seed, ctx.device)
        self.paths = leaf_paths(params)
        with part("seal"):
            state = trainer.seal_state(opt.init(params), self.key, sec)
            del params
            gc.collect()
        with part("step_fn"):
            self.step = trainer.make_train_step(
                registry.get_model(cfg), cfg, opt, sec, self.key,
                acc_dtype=configs.acc_dtype(arch), in_place=True)
        self.sealed_bytes = {
            "ctr": sum(st.ct.nbytes for tree in (state.params, state.mu,
                                                  state.nu)
                       for st in _sealed(tree)
                       if st.spec.protection.encrypts),
            "mac": sum(st.ct.nbytes for tree in (state.params, state.mu,
                                                  state.nu)
                       for st in _sealed(tree)
                       if st.spec.protection.authenticates)}
        # the first steps: warm-up, and what the check reads
        self.losses = []
        n = self.t["check_steps"]
        t_steps = time.monotonic()
        for i in range(n):
            state, m = self.step(state, self.batch(i))
            self._sync()
            t0 = time.monotonic()
            self.losses.append(float(m["loss"]))
            if not bool(m["seal_ok"]):
                self.failed += 1
            if i == 0:
                self.grad_norms = self._norms(
                    state.mu, lambda x, p: x / (1 - opt.b1))
            if i == n - 1:
                self.change_norms = self._norms(
                    state.params, lambda x, p: x - self._leaf(p, x.dtype))
            self.check_s += time.monotonic() - t0
        self.setup_parts["first_steps"] = (time.monotonic() - t_steps
                                           - self.check_s)
        self.state = state
        self.steps_done = n

    def _leaf(self, path, dtype):
        spec = next(s for s in weights.leaf_specs(self.sz)
                    if s.path == path)
        return weights.make_leaf(spec, self.ctx.seed, self.ctx.device,
                                 dtype)

    def _norms(self, tree, fn) -> list:
        """Each leaf's float32 norm of fn(unsealed leaf, its path)."""
        from repro_torch.core import sealed as sealed_lib

        out = []
        for st, path in zip(sealed_lib.tree_leaves(tree), self.paths):
            x, ok = sealed_lib.unseal(st, self.key)
            if not bool(ok):
                self.failed += 1
            out.append(float(torch.linalg.vector_norm(fn(x.float(), path))))
            del x
        return out

    # -- the window ------------------------------------------------------
    def _counts(self) -> int:
        from repro_torch.kernels.ctr_cipher import ops as ctr
        from repro_torch.kernels.tree_mac import ops as mac
        return ctr.ctr_xor.launches + mac.mac_tags.launches

    def _sync(self) -> None:
        if self.ctx.device != "cpu":
            torch.cuda.synchronize()

    def window(self, seconds: float, holder) -> dict:
        trace_at = self.t["trace_steps"]
        launches0 = self._counts()
        steps = 0
        traced_s = 0.0               # the traced step's wall, its trace read
        self._sync()
        t0 = time.perf_counter()
        while True:
            b = self.batch(self.steps_done)
            tracing = holder is not None and steps == trace_at[0]
            cm = traced(holder) if tracing else None
            if cm is not None:
                t_tr = time.perf_counter()
                cm.__enter__()
            with span("train_step"):
                self.state, m = self.step(self.state, b)
                ok, loss = bool(m["seal_ok"]), float(m["loss"])
            self._sync()
            if cm is not None:
                cm.__exit__(None, None, None)
                holder["trace"].steps = 1
                traced_s = time.perf_counter() - t_tr
            now = time.perf_counter()
            steps += 1
            self.steps_done += 1
            if not ok or loss != loss:
                self.failed += 1
            if now - t0 >= seconds:
                break
        window_s = now - t0
        self.window_steps = steps
        self.layer = {
            "sizes": self.sz, "traffic": self.t,
            "steps": steps, "window_s": window_s,
            "seal_launches_per_step": (self._counts() - launches0) / steps,
            # the whole step's share counts the untraced steps only
            "flops": (steps - (traced_s > 0)) * self.t["microbatches"]
            * self.t["batch"] * yardstick.train_flops(self.sz,
                                                      self.t["seq_len"]),
            "flops_s": window_s - traced_s,
            "traced_bytes": {k: 2 * v for k, v in self.sealed_bytes.items()},
        }
        return {"train_tok_s": steps * self.tok_per_step / window_s}

    def layer_context(self) -> dict:
        return self.layer

    def release(self) -> None:
        del self.state, self.step

    # -- the check -------------------------------------------------------
    def check(self) -> tuple:
        ref = reference_steps(self.sz, self.ctx.seed, self.ctx.device,
                              self.t, self.batch,
                              self.t["check_steps"], self.opt)
        print(f"leaves left out of change_gap (first gradient under a "
              f"thousandth of the median leaf's): "
              f"{sum(not m for m in ref['moves'])} of {len(ref['moves'])}",
              file=sys.stderr)
        numbers = train_numbers(self.losses, self.grad_norms,
                                self.change_norms, ref)
        checks = []
        for name, value in numbers.items():
            if name in self.cell.limits:
                checks.append(Check(name, value, self.cell.limits[name]))
            else:
                print(f"reading {name} {value!r} (not compared)",
                      file=sys.stderr)
        attempted = self.t["check_steps"] + self.window_steps
        return checks, attempted, self.failed


def _half(batch):
    """The fault: half of each step's batch left out (half the rows, or
    half the microbatches where a microbatch holds one row)."""
    def cut(i):
        b = batch(i)
        n, B = b["tokens"].shape[:2]
        if B > 1:
            return {k: v[:, :B // 2] for k, v in b.items()}
        return {k: v[:max(1, n // 2)] for k, v in b.items()}
    return cut


def readings(drv, ctx, control: bool) -> dict:
    """What ``bench/controls/readings.py`` records for one seed: the sound
    program's numbers and, with ``control``, the float8 control's and
    those of half the batch left out, planted in the reference."""
    def numbers(got, ref):
        return {**train_numbers(got["losses"], got["grad_norms"],
                                got["change_norms"], ref),
                "losses": got["losses"]}

    args = (drv.sz, ctx.seed, ctx.device, drv.t)
    n = drv.t["check_steps"]
    ref = reference_steps(*args, drv.batch, n, drv.opt)
    prog = {"losses": drv.losses, "grad_norms": drv.grad_norms,
            "change_norms": drv.change_norms}
    out = {"failed": drv.failed, **numbers(prog, ref),
           "left_out": sum(not m for m in ref["moves"]),
           "ref_losses": ref["losses"]}
    if control:
        low = reference_steps(*args, drv.batch, n, drv.opt,
                              precision="fp8")
        out["control_fp8"] = numbers(low, ref)
        half = reference_steps(*args, _half(drv.batch), n, drv.opt)
        out["fault_half_batch"] = numbers(half, ref)
    return out


def train_numbers(losses, grad_norms, change_norms, ref) -> dict:
    """The numbers a training cell can compare: the first step's relative
    loss gap (``loss_gap``), the worst step's (``loss_gap_steps``), and
    the worst leaf's gaps of the first gradient's norm and of the
    parameters' change."""
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    return {"loss_gap": rel[0], "loss_gap_steps": max(rel),
            "grad_norm_gap": worst_leaf(grad_norms, ref["grad_norms"]),
            "change_gap": worst_leaf(change_norms, ref["change_norms"],
                                     keep=ref["moves"])}


def _sealed(tree):
    from repro_torch.core import sealed as sealed_lib
    return sealed_lib.tree_leaves(tree)


def worst_leaf(got: list, want: list, keep=None) -> float:
    """max over leaves of |got - want| / max(want, the median leaf's
    want): the gap between the two norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = statistics.median(want[i] for i in idx)
    return max(abs(got[i] - want[i]) / max(want[i], med) for i in idx)


def reference_steps(sz, seed: int, device, t: dict, batch, n_steps: int,
                    opt, precision: str = "float32") -> dict:
    """The plain reference's first ``n_steps`` steps on the same batches:
    each step's loss, each leaf's first gradient as AdamW takes it, each
    leaf's change after the last step, and which leaves move by more than
    round-off (a first gradient over a thousandth of the median leaf's)."""
    specs = weights.leaf_specs(sz)
    skeleton: dict = {}
    for s in specs:
        weights.set_path(skeleton, s.path, None)
    by_path = {s.path: s for s in specs}
    specs = [by_path[p] for p in leaf_paths(skeleton)]
    tree: dict = {}
    leaves = []
    for s in specs:
        x = weights.make_leaf(s, seed, device, torch.float32)
        x.requires_grad_(True)
        weights.set_path(tree, s.path, x)
        leaves.append(x)
    dtypes = [s.dtype for s in specs]
    ref = reference.Ref(sz, tree, precision)
    adam = reference.AdamW(lr=opt.lr, b1=opt.b1, b2=opt.b2, eps=opt.eps,
                           weight_decay=opt.weight_decay,
                           grad_clip=opt.grad_clip)
    mu = [torch.zeros_like(x, requires_grad=False) for x in leaves]
    nu = [torch.zeros_like(x, requires_grad=False) for x in leaves]
    losses, grad_norms = [], None
    with reference.exact_float32():
        for i in range(n_steps):
            b = batch(i)
            n, rows = b["tokens"].shape[:2]
            total = 0.0
            for j in range(n):               # one sequence at a time
                for r in range(rows):
                    loss = ref.loss(b["tokens"][j, r:r + 1],
                                    b["labels"][j, r:r + 1]) / (n * rows)
                    loss.backward()
                    total += float(loss.detach())
            losses.append(total)
            grads = [x.grad for x in leaves]
            with torch.no_grad():
                adam.step(i + 1, [x.data for x in leaves], grads, mu, nu,
                          dtypes)
                if i == 0:
                    grad_norms = [float(torch.linalg.vector_norm(m))
                                  / (1 - opt.b1) for m in mu]
            for x in leaves:
                x.grad = None
    with torch.no_grad():
        change = [float(torch.linalg.vector_norm(
            x - weights.make_leaf(s, seed, device, torch.float32)))
            for x, s in zip(leaves, specs)]
    med = statistics.median(grad_norms)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change,
            "moves": [g > 1e-3 * med for g in grad_norms]}
