"""chip_smoke.py's sharded-train report, on the CPU (the run needs the
card): its cuts of train_4k and the one line a rank that
``print_sharded`` prints, with the loss against one process, the gloo
summary and the tamper verdict, each line ending in the card."""
import importlib.util
import json
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def test_sharded_reduced_lists_every_cut():
    """granite on 2 microbatches of one 1024-token sequence a step."""
    assert chip_smoke.sharded_reduced() == {
        "seq_len": [4096, 1024], "global_batch": [256, 2],
        "microbatch": [16, 1]}


def _par():
    step = [dict(wall_s=9.0, loss=11.25 + i, grad_norm=8.0, seal_ok=True,
                 ctr=539, mac=72, collectives={
                     "all_gather_into_tensor": dict(calls=37, s=6.0,
                                                    bytes=6 * 2 ** 30),
                     "all_reduce": dict(calls=8, s=1.0, bytes=2 ** 29)})
            for i in range(3)]
    sharded = dict(steps=step, launches={}, peak_bytes=34 * 2 ** 30,
                   held_bytes=14 * 10 ** 9, whole_bytes=26 * 10 ** 9,
                   build_s=2.0, tamper_leaf_col_sharded=True,
                   tamper_seal_ok=False, tamper_poisoned=True)
    return {"one_process": dict(loss=11.25, seal_ok=True, grad_norm=8.0,
                                wall_s=2.0, peak_bytes=45 * 2 ** 30),
            "ranks": [{"rank": r, "sharded": sharded} for r in range(2)]}


def test_sharded_lines_parse(capsys):
    chip_smoke.print_sharded(_par(), CARD)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "sharded train rank 0", "sharded train rank 1"]
    assert all(ln.endswith(CARD) for ln in lines)
    got = re.search(r"step 0 loss ([\d.]+) against one process's ([\d.]+) "
                    r"\(abs diff ([\d.e-]+), limit ([\d.e-]+)\)", lines[0])
    assert got.groups() == ("11.250000", "11.250000", "0", "0.001")
    cuts = re.search(r"reduced from train_4k (\{.*?\})\);", lines[0])
    assert json.loads(cuts.group(1)) == chip_smoke.sharded_reduced()
    gloo = re.search(r"gloo a step \[calls, s, bytes\] (\[.*?\]); a flipped",
                     lines[0])
    assert json.loads(gloo.group(1))[0] == {
        "all_gather_into_tensor": [37, 6.0, 6 * 2 ** 30],
        "all_reduce": [8, 1.0, 2 ** 29]}
    assert "launches a step (ctr, mac) [(539, 72), (539, 72), (539, 72)]" \
        in lines[1]
    assert "seal_ok False, state poisoned True" in lines[1]
