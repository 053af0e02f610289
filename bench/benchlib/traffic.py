"""The one traffic generator: requests and training batches from a
traffic file's parameters and ``--seed``.

Every seed gets the same sizes in another order: lengths are the
quantiles of the stated distribution, laid out in blocks that each hold
the whole set once, and the seed shuffles each block.  Any stretch of a
block's length holds the same mix, so the work a window takes in does not
swing with the seed.  Token ids are uniform over the vocabulary.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def rng_of(seed: int, stream: str) -> np.random.Generator:
    """A generator of its own per (seed, stream)."""
    return np.random.default_rng([int(seed) % (1 << 64),
                                  sum(map(ord, stream)), len(stream)])


def quantiles(dist: str, lo: float, hi: float, n: int) -> np.ndarray:
    """The n mid-quantiles (i + 1/2) / n of a distribution on [lo, hi]."""
    u = (np.arange(n) + 0.5) / n
    if dist == "log_uniform":
        return np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    if dist == "uniform":
        return lo + u * (hi - lo)
    raise ValueError(f"unknown distribution {dist!r}")


@dataclasses.dataclass
class Request:
    index: int
    client: int
    tenant: int
    prompt: np.ndarray          # int32 token ids
    max_new: int


class ClosedLoop:
    """``clients`` clients over ``tenants`` tenants, each keeping one
    request in flight: the i-th request of the sequence goes to whichever
    client asks next.  Prompt lengths and answer lengths come from
    ``prompt`` and ``new`` ({"dist", "min", "max"}, and optionally "cap",
    a length that longer draws are cut to), ``block`` requests a block."""

    def __init__(self, t: dict, seed: int, vocab: int):
        self.t, self.seed, self.vocab = t, seed, vocab
        self.clients = t["tenants"] * t["clients_per_tenant"]
        self._tok = rng_of(seed, "tokens")
        self._order = rng_of(seed, "order")
        self._sizes: list = []
        self._next = 0

    def tenant_of(self, client: int) -> int:
        return client // self.t["clients_per_tenant"]

    def _block(self) -> list:
        t, n = self.t, self.t["block"]
        p, m = t["prompt"], t["new"]
        plen = np.rint(quantiles(p["dist"], p["min"], p["max"], n))
        plen = np.minimum(plen, p.get("cap", p["max"]))
        new = np.rint(quantiles(m["dist"], m["min"] - 0.5, m["max"] + 0.5,
                                n))
        new = np.clip(new, m["min"], m["max"])
        return list(zip(self._order.permutation(plen).astype(int),
                        self._order.permutation(new).astype(int)))

    def next(self, client: int) -> Request:
        if not self._sizes:
            self._sizes = self._block()
        plen, new = self._sizes.pop(0)
        prompt = self._tok.integers(0, self.vocab, size=int(plen),
                                    dtype=np.int64).astype(np.int32)
        r = Request(self._next, client, self.tenant_of(client), prompt,
                    int(new))
        self._next += 1
        return r


def train_batch(t: dict, seed: int, step: int, vocab: int) -> dict:
    """Step ``step``'s batch: {"tokens", "labels"} int32 [n_micro, B, S],
    every row its own draw (labels are the next token)."""
    n, B, S = t["microbatches"], t["batch"], t["seq_len"]
    rng = rng_of(seed, f"train/{step}")
    seq = rng.integers(0, vocab, size=(n, B, S + 1), dtype=np.int64)
    seq = seq.astype(np.int32)
    return {"tokens": seq[..., :-1], "labels": seq[..., 1:]}
