"""The control at a size a test run holds: the plain reference in
float8 put in the program's place reads well above the sound program, on
the CPU at the configurations' small sizes, through the same readings
the card's runs take (each driver's ``readings``, which
``bench/controls/readings.py`` calls)."""
from pathlib import Path

from benchlib.cell import Cell
from benchlib.harness import Ctx

ROOT = Path(__file__).resolve().parents[2]


def _driven(workload, seed, seconds=3.0, **traffic):
    cell = Cell.load(ROOT, workload)
    cell.traffic.update(traffic)
    ctx = Ctx(seed=seed, seconds=seconds, trace=False, device="cpu",
              smoke=True)
    mod = cell.driver()
    drv = mod.make(cell, ctx)
    drv.setup()
    drv.window(ctx.seconds, None)
    drv.release()
    return mod, drv, ctx


def test_serving_control_reads_above_the_program():
    from test_bench_faults import SERVE
    mod, drv, ctx = _driven("granite-serve-code", 32, seconds=8.0,
                            **dict(SERVE, check_tokens=60))
    r = mod.readings(drv, ctx, control=True)
    assert r["sample_tokens"] >= 30
    assert r["control_fp8"]["served_logit_gap"] > 3 * r["served_logit_gap"]


def test_training_control_and_half_batch_read_above_the_program():
    mod, drv, ctx = _driven("granite-train-8k", 37, seq_len=32)
    r = mod.readings(drv, ctx, control=True)
    for fault in ("control_fp8", "fault_half_batch"):
        assert any(r[fault][k] > 3 * r[k] for k in
                   ("loss_gap", "grad_norm_gap", "change_gap")), r
