"""Benchmark workloads from the paper's evaluation (§4.2); a copy of
``repro.accel.workloads`` (pure Python).

AlexNet layers follow the one-weird-trick variant the paper cites [11]:
Conv4 (13x13, 384 -> 256, 3x3), Conv5 (13x13, 256 -> 256, 3x3),
FC1 (9216 -> 4096), FC2 (4096 -> 4096), batch 1, int8 data (VTA native).
ResNet-18 is the standard 224x224 network (TVM v0.6's end-to-end VTA model).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerWork:
    name: str
    macs: float          # multiply-accumulates
    bytes_rd: float      # DRAM reads (int8 weights/activations + int32 acc)
    bytes_wr: float      # DRAM writes
    piece_bytes: int = 2048   # DMA burst granularity (conv spatial tiles are
                              # small; FC/compiled-ResNet stream 2KB chunks)


def conv(name, h, w, cin, cout, kh=3, kw=3, stride=1, batch=1) -> LayerWork:
    ho, wo = h // stride, w // stride
    macs = batch * ho * wo * cout * cin * kh * kw
    rd = batch * h * w * cin + kh * kw * cin * cout
    wr = batch * ho * wo * cout
    return LayerWork(name, macs, rd, wr, piece_bytes=256)


def fc(name, d_in, d_out, batch=1) -> LayerWork:
    macs = batch * d_in * d_out
    rd = d_in * d_out + batch * d_in
    wr = batch * d_out
    return LayerWork(name, macs, rd, wr)


CONV4 = conv("Conv4", 13, 13, 384, 256)
CONV5 = conv("Conv5", 13, 13, 256, 256)
FC1 = fc("FC1", 9216, 4096)
FC2 = fc("FC2", 4096, 4096)


def resnet18() -> LayerWork:
    layers = [conv("c1", 224, 224, 3, 64, 7, 7, stride=2)]
    cfg = [(56, 64, 64), (56, 64, 128), (28, 128, 128), (28, 128, 256),
           (14, 256, 256), (14, 256, 512), (7, 512, 512)]
    # stage 1: two blocks at 56x56x64
    for _ in range(4):
        layers.append(conv("s1", 56, 56, 64, 64))
    # stages 2-4: first conv downsamples
    for (hw, cin, cout) in [(56, 64, 128), (28, 128, 256), (14, 256, 512)]:
        layers.append(conv("d", hw, hw, cin, cout, stride=2))
        layers.append(conv("k", hw // 2, hw // 2, cout, cout))
        layers.append(conv("p", hw // 2, hw // 2, cin, cout, 1, 1, stride=2))
        for _ in range(2):
            layers.append(conv("r", hw // 2, hw // 2, cout, cout))
    layers.append(fc("fc", 512, 1000))
    # TVM's end-to-end compilation emits large contiguous loads (paper §4.3
    # credits compilation optimization for the low overhead) => 2KB pieces.
    return LayerWork("ResNet-18",
                     sum(l.macs for l in layers),
                     sum(l.bytes_rd for l in layers),
                     sum(l.bytes_wr for l in layers),
                     piece_bytes=2048)


RESNET18 = resnet18()

TABLE1 = (CONV4, CONV5, FC1, FC2, RESNET18)

# Paper Table 1 ground truth: (vta_cycles, trusted_slowdown, ctr_slowdown)
PAPER_TABLE1 = {
    "Conv4": (2_782_962, 1.074, 1.032),
    "Conv5": (1_879_117, 1.109, 1.048),
    "FC1": (5_418_983, 5.407, 1.110),
    "FC2": (2_412_609, 5.402, 1.112),
    "ResNet-18": (29_964_469, 1.079, 1.009),
}
