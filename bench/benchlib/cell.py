"""One cell of BENCHMARK.json, resolved to its files by name.

The harness holds no list of configurations, families, traffic mixes or
metrics: ``bench/configs/<config>.json`` is the configuration (its
``family`` names ``bench/families/<family>.py``), ``bench/traffic/
<traffic>.json`` the mix (its ``kind`` names the driver,
``bench/drivers/<kind>.py``), ``bench/limits/<workload>.json`` the limits
of the comparison that decides ``correct``, and ``bench/metrics/<name>.py``
the reader of each per-layer metric.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

from .files import BENCH, load_json, load_module
from .sizes import sizes_of


def port_config(entry: dict, smoke: bool = False):
    """The port's ModelConfig for a configuration file: the port's config
    of ``arch_id`` given every size the file runs, the fields its family
    file adds, and the file's ``run`` settings; it raises where the port
    would run anything else (``smoke``: the file's small CPU-test sizes)."""
    from repro_torch import configs

    sz = sizes_of(entry, smoke)
    base = configs.get_config(entry["arch_id"])
    top = dict(n_layers=sz.n_layers, d_model=sz.d_model,
               n_heads=sz.n_heads, n_kv_heads=sz.n_kv_heads,
               head_dim=sz.head_dim, d_ff=sz.d_ff, vocab=sz.vocab,
               rope_theta=sz.rope_theta, norm_eps=sz.norm_eps,
               tie_embeddings=sz.tie_embeddings, dtype=sz.dtype,
               param_dtype=sz.dtype, **entry.get("run", {}))
    top.update(sz.fam.port_fields(sz, base))
    cfg = base.with_(**top)
    if cfg.family != sz.fam.PORT_FAMILY or cfg.hd != sz.hd:
        raise ValueError(f"{entry['name']}: the port runs family "
                         f"{cfg.family} at head_dim {cfg.hd}")
    return cfg


@dataclasses.dataclass
class Cell:
    root: Path                   # the checkout (BENCHMARK.json's folder)
    bench: dict                  # BENCHMARK.json
    workload: dict               # its entry in ``workloads``
    config: dict                 # bench/configs/<config>.json
    traffic: dict                # bench/traffic/<traffic>.json
    limits: dict                 # bench/limits/<workload>.json

    @classmethod
    def load(cls, root: Path, name: str) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        wl = next((w for w in bench["workloads"] if w["name"] == name), None)
        if wl is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        centry = next(c for c in bench["configs"]
                      if c["name"] == wl["config"])
        return cls(root=root, bench=bench, workload=wl,
                   config=load_json(root / centry["file"]),
                   traffic=load_json(BENCH / "traffic"
                                     / f"{wl['traffic']}.json"),
                   limits=load_json(BENCH / "limits" / f"{name}.json"))

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def driver(self):
        kind = self.traffic["kind"]
        return load_module(BENCH / "drivers" / f"{kind}.py", kind)

    def reader(self, metric: str):
        return load_module(BENCH / "metrics" / f"{metric}.py", metric)
