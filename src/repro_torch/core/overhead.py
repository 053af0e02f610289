"""Analytical overhead model (paper §3.4); a copy of ``repro.core.overhead``
(pure Python), with the H100's model in place of the reference's
accelerator constants.

"The total run time of a machine learning task is composed of computation and
memory access. [...] our protection methods additionally introduce encryption,
decryption, and message authentication, all of which are bound to memory
access."  Slowdown therefore scales with memory-access *intensity* (words per
FLOP): ~1 word/FLOP for GEMV (the paper's FC rows) vs ~1/(Ho*Wo) for conv.

This module predicts the slowdown of a (workload, accelerator, protection)
triple.  It backs two things:
  * the VTA cycle simulator calibration (``accel/vta_sim.py``, Table 1),
  * the price of sealed bytes on the card (``H100``), which the cost
    ledger's drift report (``obs/costs.py``) and the profiler's report
    use: the crypto term rides on the HBM-bytes term exactly as the
    paper's crypto engine rides on DRAM access.
"""
from __future__ import annotations

import dataclasses

from .policy import Protection


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    flops: float            # useful MACs*2
    bytes_read: float       # DRAM reads touched by the engine
    bytes_written: float    # DRAM writes

    @property
    def bytes_total(self) -> float:
        return self.bytes_read + self.bytes_written

    @property
    def intensity_words_per_flop(self) -> float:
        return (self.bytes_total / 4.0) / max(self.flops, 1.0)


@dataclasses.dataclass(frozen=True)
class AcceleratorModel:
    """Throughput/latency model of an accelerator + its security layer."""
    name: str
    flops_per_cycle: float          # core compute rate
    dram_bytes_per_cycle: float     # DRAM bandwidth at the interface
    # crypto engine: counter-mode unit (pipelined) and MAC unit
    ctr_bytes_per_cycle: float      # keystream+XOR throughput (pipelined AES/ARX)
    ctr_pipeline_latency: float     # cycles to fill the pipe (paper: 29)
    mac_cycles_per_16b: float       # cycles per 128-bit block of MAC input
    mac_pipelined: bool             # paper's GFM: False (serial); tree MAC: True
    chunk_bytes: int = 2048         # MAC verification granularity s
    clock_hz: float | None = None   # cycles per second, where the model has one

    def crypto_cycles(self, n_bytes: float, encrypts: bool = True,
                      authenticates: bool = True) -> float:
        """Crypto-engine cycles to seal/unseal ``n_bytes`` through the
        memory path.  Shared by ``step_cycles`` and the cost-attribution
        ledger (obs/costs.py ``CostLedger.reconcile``), so the per-phase
        drift report prices bytes with exactly the model the roofline uses.
        """
        if n_bytes <= 0:
            return 0.0
        crypto = 0.0
        if encrypts:
            # CTR is pipelined: adds latency per chunk but streams at full rate.
            n_chunks = max(1.0, n_bytes / self.chunk_bytes)
            crypto += (n_bytes / self.ctr_bytes_per_cycle
                       + n_chunks * self.ctr_pipeline_latency)
        if authenticates:
            blocks = n_bytes / 16.0
            if self.mac_pipelined:
                # tree MAC: log-depth, streams with the fetch; model as an
                # extra pass at CTR-like throughput plus per-chunk log depth.
                n_chunks = max(1.0, n_bytes / self.chunk_bytes)
                import math
                depth = math.ceil(math.log2(max(2.0, self.chunk_bytes / 16.0)))
                crypto += blocks + n_chunks * depth
            else:
                # paper's serial GFM: ceil(s/128bit) * 8 cycles, fully serial,
                # NOT overlapped with the fetch stream.
                crypto += blocks * self.mac_cycles_per_16b
        return crypto

    def step_cycles(self, w: Workload, prot: Protection) -> float:
        """Cycle estimate: compute/memory overlap, crypto bound to memory path."""
        compute = w.flops / self.flops_per_cycle
        mem = w.bytes_total / self.dram_bytes_per_cycle
        crypto = self.crypto_cycles(w.bytes_total, encrypts=prot.encrypts,
                                    authenticates=prot.authenticates)
        # compute overlaps with (mem + crypto) up to the max (double buffering);
        # serial MAC does not overlap, which the max() structure captures since
        # crypto inflates the memory-path term.
        return max(compute, mem + crypto)

    def slowdown(self, w: Workload, prot: Protection) -> float:
        return self.step_cycles(w, prot) / self.step_cycles(w, Protection.NONE)


# One NVIDIA H100 80GB HBM3 (SXM, power limit 700.00 W as nvidia-smi
# --query-gpu=name,power.limit gives it) and the port's two crypto kernels,
# from the bounds of PERF.md's kernel table: a cycle is one of the 1.98 GHz
# boost clock; bf16 at 989 TFLOP/s on the tensor cores, HBM3 at 3.35 TB/s.
# The CTR and MAC kernels are integer work on 132 SMs x 64 INT32 lanes a
# cycle: 42 ALU-pipe operations a Threefry block (8 bytes of keystream)
# and 14 a MAC word.  Each is a kernel pass of its own over the bytes, not
# streamed with the fetch, so the MAC is priced per 16-byte block at its
# lanes' rate (``mac_pipelined=False``: the serial term), and there is no
# per-chunk pipeline fill.
_H100_CLOCK_HZ = 1.98e9
_H100_INT32_LANES = 132 * 64
H100 = AcceleratorModel(
    name="h100-sealed",
    flops_per_cycle=989e12 / _H100_CLOCK_HZ,
    dram_bytes_per_cycle=3.35e12 / _H100_CLOCK_HZ,
    ctr_bytes_per_cycle=_H100_INT32_LANES / 42 * 8,
    ctr_pipeline_latency=0.0,
    mac_cycles_per_16b=4 * 14 / _H100_INT32_LANES,
    mac_pipelined=False,
    chunk_bytes=2048,
    clock_hz=_H100_CLOCK_HZ,
)


def gemm_workload(name: str, m: int, n: int, k: int, dtype_bytes: int = 1,
                  batch: int = 1) -> Workload:
    flops = 2.0 * batch * m * n * k
    reads = batch * (m * k + k * n) * dtype_bytes
    writes = batch * m * n * dtype_bytes
    return Workload(name, flops, reads, writes)


def conv2d_workload(name: str, h: int, w: int, cin: int, cout: int,
                    kh: int, kw: int, dtype_bytes: int = 1, batch: int = 1,
                    stride: int = 1, pad: int | None = None) -> Workload:
    if pad is None:
        pad = kh // 2
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    flops = 2.0 * batch * ho * wo * cout * cin * kh * kw
    reads = (batch * h * w * cin + kh * kw * cin * cout) * dtype_bytes
    writes = batch * ho * wo * cout * dtype_bytes
    return Workload(name, flops, reads, writes)
