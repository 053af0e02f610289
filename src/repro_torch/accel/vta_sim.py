"""Cycle-level model of the customized (trusted) VTA — paper §4 case study
(a copy of ``repro.accel.vta_sim``; pure Python).

Models the VTA core + the paper's security layer:

  * GEMM core: 16x16x1 int8 MACs/cycle, with an empirical utilization factor
    calibrated against the paper's measured VTA column of Table 1 (the RTL
    pipeline never sustains peak on these layers).
  * DRAM interface: ``dram_bytes_per_cycle`` (AXI burst).
  * AES-CTR unit (VTA-ctr/VTA-trusted): pipelined, 1x128-bit block/cycle
    throughput, 29-cycle pipeline latency per 2KB staging-buffer chunk
    (the paper's tiny_aes core) — latency fills are visible, streaming
    overlaps with the DMA.
  * GFM (GMAC) unit (VTA-trusted): ceil(s/128bit) x 8 cycles per piece,
    serial Horner chain — the paper's non-pipelined module.  A fraction of
    the GMAC time hides under compute slack (double-buffered tiles let the
    MAC of chunk i+1 run while chunk i computes); ``gfm_overlap`` is
    calibrated on the conv rows of Table 1.
  * Tree MAC (our §4.3-style replacement): O(log) depth, streams like AES —
    its cost model upper-bounds at the VTA-ctr row, exactly the paper's
    stated bound for parallel authentication.

The goal is reproducing Table 1's overhead STRUCTURE (conv ~1.07-1.11x,
FC ~5.4x, ctr <= 1.11x) with one global calibration, not RTL exactness;
``table_row`` gives a workload's row beside ``workloads.PAPER_TABLE1``.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.policy import Protection
from .workloads import LayerWork


@dataclasses.dataclass(frozen=True)
class VTAConfig:
    macs_per_cycle: float = 256.0          # 16x16 GEMM core
    utilization: float = 0.21              # calibrated on Table 1 conv rows
    dram_bytes_per_cycle: float = 8.0      # calibrated on FC rows (mem-bound)
    chunk_bytes: int = 2048                # the 2KB staging buffer (paper §4.1)
    aes_latency: int = 29                  # tiny_aes pipeline depth
    aes_bytes_per_cycle: float = 16.0      # 128-bit/cycle once full
    gfm_cycles_per_16b: float = 8.0        # non-pipelined GFM (paper §4.2)
    gfm_overlap: float = 0.72              # fraction hideable under compute slack
    tree_mac_bytes_per_cycle: float = 16.0 # our parallel MAC streams like AES
    mac_scheme: str = "gfm"                # "gfm" (paper) | "tree" (§4.3)


def simulate(cfg: VTAConfig, w: LayerWork, prot: Protection) -> dict:
    """Returns cycle breakdown for one workload under one protection level."""
    compute = w.macs / (cfg.macs_per_cycle * cfg.utilization)
    total_bytes = w.bytes_rd + w.bytes_wr
    mem = total_bytes / cfg.dram_bytes_per_cycle
    n_pieces = math.ceil(total_bytes / w.piece_bytes)
    n_chunks = math.ceil(total_bytes / cfg.chunk_bytes)

    aes_visible = 0.0
    mac_visible = 0.0
    if prot.encrypts:
        # AES streaming (1 block/cycle) always keeps up with the DMA burst;
        # the visible cost is the pipeline fill per load piece.
        aes_visible = n_pieces * cfg.aes_latency
    if prot.authenticates:
        if cfg.mac_scheme == "gfm":
            gmac = (total_bytes / 16.0) * cfg.gfm_cycles_per_16b
            slack = max(0.0, compute - (mem + aes_visible))
            hidden = min(gmac, slack) * cfg.gfm_overlap
            mac_visible = gmac - hidden
        else:  # tree MAC: streams at AES-like rate, upper bound = ctr row
            depth = math.ceil(math.log2(max(2, cfg.chunk_bytes // 16)))
            mac_visible = n_chunks * depth

    base = max(compute, mem)
    total = base + aes_visible + mac_visible
    return {
        "compute": compute, "mem": mem, "aes_visible": aes_visible,
        "mac_visible": mac_visible, "total": total,
        "base_total": base,
    }


def table_row(cfg: VTAConfig, w: LayerWork) -> dict:
    base = simulate(cfg, w, Protection.NONE)["total"]
    trusted = simulate(cfg, w, Protection.TRUSTED)["total"]
    ctr = simulate(cfg, w, Protection.CTR)["total"]
    tree_cfg = dataclasses.replace(cfg, mac_scheme="tree")
    tree = simulate(tree_cfg, w, Protection.TRUSTED)["total"]
    return {
        "name": w.name, "vta": base,
        "trusted": trusted, "trusted_slowdown": trusted / base,
        "ctr": ctr, "ctr_slowdown": ctr / base,
        "tree": tree, "tree_slowdown": tree / base,
    }
