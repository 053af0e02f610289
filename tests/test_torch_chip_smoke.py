"""chip_smoke.py's own arithmetic, on the CPU (the script's run needs the
card): the device-busy sum of a profile, the sealed-attention bound, and
the refusal to run without a card."""
import importlib.util
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def test_device_busy_counts_each_kernel_once():
    """A CPU operator's row repeats the device time of the kernels it
    launched; only the kernel rows add up to the busy time."""
    rows = [types.SimpleNamespace(device_type=DeviceType.CPU,
                                  self_device_time_total=5.0),
            types.SimpleNamespace(device_type=DeviceType.CUDA,
                                  self_device_time_total=5.0),
            types.SimpleNamespace(device_type=DeviceType.CUDA,
                                  self_device_time_total=3.0)]
    prof = types.SimpleNamespace(key_averages=lambda: rows)
    kept = chip_smoke.device_events(prof)
    assert sum(e.self_device_time_total for e in kept) == 8.0


@pytest.mark.parametrize("verify, ops", [(False, 155_189_248),
                                         (True, 155_189_248 + 83_886_080)])
def test_sealed_attention_bound_counts_the_valid_rows(verify, ops):
    """One granite layer at B 8, T 1024, K 8, G 4, hd 64: 131,072 K+V rows
    of 16 Threefry blocks (74 operations each) and, verifying, 32 MAC words
    (20 each); operations bound it."""
    b = chip_smoke.attention_bound(8, 8, 4, 64, 1024, verify)
    assert b["ops"] == ops
    assert b["bytes"] == (2 * 8 * 8 * 4 * 64 * 2 + 2 * 65536 * 128 + 256
                          + (2 * 65536 * 4 if verify else 0))
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] > b["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
    half = chip_smoke.attention_bound(8, 8, 4, 64, 512, verify)
    assert half["ops"] * 2 == ops


@pytest.mark.parametrize("M, K, N, bytes_ms, ops_ms", [
    (8192, 2048, 8192, 0.061, 0.058), (8192, 8192, 2048, 0.061, 0.144)])
def test_sealed_matmul_bound_is_set_by_the_tensor_cores(M, K, N, bytes_ms,
                                                        ops_ms):
    """Granite's MLP products of one 8192-token microbatch: 2MKN FLOP at
    989 TFLOP/s (0.278 ms) bound them, over the bytes of A, B, their tags
    and C and the integer work the inputs need (one Threefry block per
    four bf16, one MAC word per two); the kernel's 128-tile keystream
    regeneration is 18.5 MKN (2/128) operations."""
    b = chip_smoke.matmul_bound(M, K, N)
    elems = M * K + K * N
    assert b["ops"] == elems // 4 * 74 + elems // 2 * 20
    assert b["bytes"] == 2 * elems + 2 * M * N + elems // 64
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(2 * M * K * N / 989e12 * 1e3)
    assert 0.277 < b["bound_ms"] < 0.279
    assert b["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3 < bytes_ms
    assert b["ops"] / chip_smoke.INT32_OPS_PER_S * 1e3 < ops_ms
    assert b["keystream_ops"] == pytest.approx(18.5 * M * K * N * 2 / 128)


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""
