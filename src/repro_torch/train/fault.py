"""Fault tolerance: supervised training loop with checkpoint/restart,
failure injection, straggler mitigation and the elastic restore onto a
device mesh (torch port of ``repro.train.fault``).

On a real cluster the failure signal comes from the coordinator (missed
heartbeats / ICI timeouts); here ``FailureInjector`` raises at configured
steps so the recovery path is exercised end-to-end in tests and examples.
Interfaces are the production ones: the loop only sees step callables,
checkpoint save/restore, and a deadline policy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..core.sealed import ResealCounter
from . import checkpoint


class NodeFailure(RuntimeError):
    pass


def _block_until_ready(x) -> None:
    """Wait for the card's queued work, so a step's time is its own."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


@dataclasses.dataclass
class FailureInjector:
    """Raises NodeFailure the first time each configured step is reached."""
    fail_at_steps: tuple = ()

    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise NodeFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerPolicy:
    """Per-step deadline relative to the running median step time."""
    factor: float = 3.0
    warmup_steps: int = 3

    _times: list = dataclasses.field(default_factory=list)

    def observe(self, dt: float) -> bool:
        """Record a step time; True if this step counts as a straggler."""
        self._times.append(dt)
        if len(self._times) <= self.warmup_steps:
            return False
        med = sorted(self._times[:-1])[len(self._times[:-1]) // 2]
        return dt > self.factor * med


@dataclasses.dataclass
class Supervisor:
    """Checkpointed training loop with restart-on-failure."""
    step_fn: Callable                   # (state, batch) -> (state, metrics)
    batch_fn: Callable                  # step_idx -> batch (deterministic)
    ckpt_dir: str
    key_bytes: bytes
    save_every: int = 10
    injector: Optional[FailureInjector] = None
    straggler: Optional[StragglerPolicy] = None
    # Sealed-training nonce-lane budget: every step re-seals the state (+1
    # per leaf lane), and seal_tree lanes are TREE_LEAF_STRIDE wide.  The
    # guard counts resealings; when the budget is spent, refresh_fn must
    # re-seal the state under a fresh epoch (keystream lanes reset) — with a
    # guard but no refresh_fn, the loop fails closed (NonceLaneExhausted)
    # rather than reuse keystream across leaves.
    lane_guard: Optional[ResealCounter] = None
    refresh_fn: Optional[Callable] = None       # state -> re-sealed state
    # optional obs.Monitor: fed the lane guard's headroom each step, so the
    # "reseal_lanes" HeadroomRule warns *before* the budget forces a refresh
    monitor: Optional[object] = None
    # checkpoint the entry state before the first step: a step that reseals
    # in place consumes the state passed in, so a failure before the first
    # periodic save has nothing else to restart from
    save_at_start: bool = False

    def run(self, state, n_steps: int, start_step: int = 0, log=None):
        log = log or (lambda *a: None)
        abstract = state
        step = start_step
        metrics = {}
        events = {"failures": 0, "restarts": 0, "stragglers": 0, "saves": 0,
                  "lane_refreshes": 0}
        if self.save_at_start:
            checkpoint.save(self.ckpt_dir, start_step, state, self.key_bytes)
            events["saves"] += 1
        while step < n_steps:
            try:
                if self.injector:
                    self.injector.check(step)
                if self.lane_guard is not None:
                    if self.lane_guard.exhausted and self.refresh_fn:
                        state = self.refresh_fn(state)
                        self.lane_guard.reset()
                        events["lane_refreshes"] += 1
                        log(f"step {step}: nonce-lane budget spent — state "
                            "re-sealed under a fresh epoch")
                    self.lane_guard.note()
                t0 = time.perf_counter()
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                _block_until_ready(metrics.get("loss"))
                dt = time.perf_counter() - t0
                if self.straggler and self.straggler.observe(dt):
                    events["stragglers"] += 1
                    log(f"step {step}: straggler ({dt:.3f}s) — flagged for "
                        "reassignment")
                step += 1
                if self.monitor is not None and self.lane_guard is not None:
                    self.monitor.observe(
                        step, headroom=[self.lane_guard.headroom()
                                        | {"id": "train_lanes"}])
                if step % self.save_every == 0 or step == n_steps:
                    checkpoint.save(self.ckpt_dir, step, state, self.key_bytes)
                    events["saves"] += 1
            except NodeFailure as e:
                events["failures"] += 1
                if self.lane_guard is not None:
                    # A restored checkpoint carries *older* leaf nonces than
                    # the state we just lost, so the guard's count no longer
                    # matches the lanes — force a refresh (fresh epoch) before
                    # the next reseal rather than under-count and reuse
                    # keystream.
                    self.lane_guard.count = self.lane_guard.limit
                log(f"FAILURE: {e}; restoring last checkpoint")
                last = checkpoint.latest(self.ckpt_dir)
                if last is None:
                    log("no checkpoint yet; restarting from initial state")
                    # the state passed in at entry (an in-place step has
                    # consumed it, and the replay's unseal then raises)
                    state = abstract
                    step = start_step
                    events["restarts"] += 1
                else:
                    path, ck_step = last
                    state, _ = checkpoint.restore(path, abstract, self.key_bytes)
                    step = ck_step
                    events["restarts"] += 1
        return state, metrics, events


def elastic_restore(path: str, abstract_state, key_bytes: bytes, mesh,
                    logical_specs):
    """Restore a checkpoint onto a (possibly different) mesh — elastic
    scaling.

    logical_specs: the plaintext tree of logical axis tuples (see
    ``parallel/sharding.py``); every leaf of ``abstract_state`` (sealed or
    not, real or on the meta device) becomes a DTensor of this rank's block
    under ``parallel.sharding.tree_named_shardings``, so a checkpoint
    written by one process restores onto any mesh whose axes divide the
    dims."""
    from ..parallel.sharding import tree_named_shardings
    shardings = tree_named_shardings(logical_specs, mesh, abstract_state)
    return checkpoint.restore(path, abstract_state, key_bytes,
                              shardings=shardings)
