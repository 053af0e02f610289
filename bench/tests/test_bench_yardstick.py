"""The yardstick's arithmetic against hand counts."""
import json
import math
from pathlib import Path

import pytest

from benchlib import readers, weights, yardstick
from benchlib.sizes import sizes_of
from benchlib.profiling import Trace

BENCH = Path(__file__).resolve().parents[1]


def _cfg(name):
    return sizes_of(json.loads((BENCH / "configs" / f"{name}.json")
                                   .read_text()))


def test_granite_parameters_and_sealed_state_by_hand():
    cfg = _cfg("granite-3-2b")
    D, F, V = 2048, 8192, 49155
    layer = 2 * D + D * D + 2 * D * 512 + D * D + 3 * D * F
    n = V * D + 40 * layer + D + D * V
    assert n == weights.n_params(cfg) == 2_634_201_088
    # the published model ties the unembedding to the embedding
    assert n - D * V == 2_533_531_648
    # bf16 parameters, float32 first and second moments: 10 bytes each
    assert 10 * weights.n_params(cfg) == 26_342_010_880


def test_ctr_and_mac_bounds_by_hand():
    gb = 1e9
    # 1 GB read and written at 3.35 TB/s; its 125 M Threefry blocks at 42
    # ALU operations over 132 * 64 * 1.98e9 a second take less
    assert yardstick.ctr_bound_s(gb) == pytest.approx(2e9 / 3.35e12)
    ops = gb / 8 * 42 / (132 * 64 * 1.98e9)
    assert ops < 2e9 / 3.35e12
    assert yardstick.mac_bound_s(gb) == pytest.approx(1e9 / 3.35e12)


def test_model_flops_by_hand():
    cfg = _cfg("granite-3-2b")
    N = weights.n_params(cfg) - 49155 * 2048 - 40 * 2 * 2048 - 2048
    assert yardstick.matmul_params(cfg) == N
    # one 4096-token sequence: 6N a token, plus three times the forward
    # attention's 4 * H * hd FLOPs a (query, key) pair, over 40 layers
    attn = 4 * 32 * 64 * (4096 * 4097 / 2) * 40
    assert yardstick.train_flops(cfg, 4096) == pytest.approx(
        6 * N * 4096 + 3 * attn)
    # a decode token at position 1000 attends to 1001 keys
    assert yardstick.forward_flops(cfg, 1, 1000) == pytest.approx(
        2 * N + 4 * 32 * 64 * 1001 * 40)


def test_roofline_and_idle_from_a_trace():
    # 2 GB through the CTR kernel in 1 ms of kernel time: bound 1.194 ms
    tr = Trace(device=[("ctr_xor_kernel<int>", 0, 600_000),
                       ("ctr_xor_kernel<int>", 1_000_000, 1_400_000),
                       ("gemm", 1_200_000, 1_500_000)],
               host=[], spans=[("bench.step", 0, 2_000_000)],
               window_s=0.002, steps=1)
    ctx = {"trace": tr, "traced_bytes": {"ctr": 1e9}}
    want = 100 * (2e9 / 3.35e12) / 1e-3
    assert readers.ctr_roofline(ctx) == pytest.approx(want)
    assert tr.busy_s() == pytest.approx(1.1e-3)
    assert readers.idle_share(ctx) == pytest.approx(45.0)
    assert readers.kernel_launches(ctx) == 3
    assert tr.idle_gaps() == [["bench.step", pytest.approx(4e-4)]]


def test_readers_return_nothing_where_nothing_ran():
    tr = Trace(device=[], host=[], spans=[], window_s=1.0, steps=1)
    ctx = {"trace": tr, "traced_bytes": {"ctr": 1e9, "mac": 1e9}}
    assert readers.ctr_roofline(ctx) is None
    assert readers.mac_roofline(ctx) is None
    assert readers.idle_share(ctx) is None
    assert readers.percentile([], 90) is None


def test_nearest_rank_percentile():
    v = list(range(1, 101))
    assert readers.percentile(v, 90) == 90
    assert readers.percentile([5.0], 90) == 5.0
    assert readers.percentile(list(range(1, 11)), 90) == 9
    assert math.isclose(readers.percentile([3, 1, 2], 100), 3)
