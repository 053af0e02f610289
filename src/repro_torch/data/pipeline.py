"""Deterministic synthetic data pipeline (a copy of ``repro.data.pipeline``;
numpy only, so the port does not import the reference).

Step-indexed and stateless: ``batch_at(step)`` is a pure function of
(seed, step), so restart-from-checkpoint replays the exact stream with no
data-loader state to persist — the fault-tolerance story for the input path.

The token stream is a noisy affine recurrence, t_{i+1} = (a * t_i + b + eps)
mod V with eps sparse — learnable structure so example training runs show a
real loss drop, not just noise fitting.

Sealed ingestion (paper Rule 1): ``sealed_host_batches`` seals each batch with
the channel key before it is handed to the step, which unseals it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import sealed as sealed_lib
from ..core.policy import SealedSpec


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    a: int = 5
    b: int = 131
    noise_every: int = 7

    def batch_at(self, step: int, extra: dict | None = None) -> dict:
        """tokens and labels [B, S]; ``extra`` maps a frontend input's name
        (``patch_embeds``, ``frame_embeds``) to its per-sequence shape,
        drawn N(0, 1) in float32 after the tokens."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2 ** 31))
        B, S, V = self.batch, self.seq_len, self.vocab
        t0 = rng.randint(0, V, size=(B, 1))
        toks = [t0]
        for i in range(S):
            nxt = (self.a * toks[-1] + self.b) % V
            if i % self.noise_every == 0:
                nxt = (nxt + rng.randint(0, 3, size=(B, 1))) % V
            toks.append(nxt)
        seq = np.concatenate(toks, axis=1).astype(np.int32)   # [B, S+1]
        out = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if extra:
            for k, shape in extra.items():
                out[k] = rng.standard_normal(size=(B, *shape)).astype(
                    np.float32)
        return out

    def microbatches_at(self, step: int, n_micro: int,
                        extra: dict | None = None) -> dict:
        """Stacked microbatches [n_micro, B, ...] for grad accumulation."""
        bs = [self.batch_at(step * n_micro + i, extra)
              for i in range(n_micro)]
        return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def sealed_host_batches(batch: dict, key, spec: SealedSpec, nonce_base: int):
    """Seal a batch of tensors leaf-wise (paper Rule 1: encrypted in
    transit)."""
    return sealed_lib.seal_tree(batch, key, spec, nonce_base)
