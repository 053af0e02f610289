"""A configuration file's sizes, read by the benchmark itself.

The weights, the reference and the yardstick take their sizes from here
and never from the program's config objects, so a default changed inside
the program cannot move the reference with it.  ``cell.port_config``
builds the program's config from the same file and holds it to these
sizes.

A configuration file holds the published config's keys with the published
values.  Where the port's model runs a key otherwise, the file says so
under ``departures`` ({key: the value the port runs}), and the values run
are the published ones with the departures laid over them.
"""
from __future__ import annotations

import dataclasses

import torch

from . import files

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Sizes:
    family: str                  # bench/families/<family>.py
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float
    tie_embeddings: bool
    dtype: str
    # every value run, for the keys that only the family's file reads
    values: dict = dataclasses.field(default_factory=dict, compare=False,
                                     hash=False, repr=False)

    @property
    def hd(self) -> int:
        return self.head_dim

    @property
    def p_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def fam(self):
        """The family's module: its leaves, equations and FLOP counts."""
        return files.family(self.family)


def values_run(entry: dict, smoke: bool = False) -> dict:
    """The values a configuration runs: the published ones with the port's
    ``departures`` over them (``smoke``: and the small CPU-test sizes)."""
    e = {**entry, **entry.get("departures", {})}
    if smoke:
        e.update(entry.get("smoke", {}))
    return e


def sizes_of(entry: dict, smoke: bool = False) -> Sizes:
    """The sizes a configuration file runs."""
    e = values_run(entry, smoke)
    return Sizes(
        family=e["family"], n_layers=e["num_hidden_layers"],
        d_model=e["hidden_size"], n_heads=e["num_attention_heads"],
        n_kv_heads=e["num_key_value_heads"], head_dim=e["head_dim"],
        d_ff=e["intermediate_size"], vocab=e["vocab_size"],
        rope_theta=float(e["rope_theta"]), norm_eps=float(e["rms_norm_eps"]),
        tie_embeddings=bool(e["tie_word_embeddings"]),
        dtype=e["torch_dtype"], values=e)
