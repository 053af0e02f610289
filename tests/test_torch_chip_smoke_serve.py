"""chip_smoke.py's sharded-serving report, on the CPU (the run needs the
card): its cuts of prefill_32k and decode_32k, the one line a rank that
``print_sharded_serve`` prints, the dry run's cells of the parallel phase
and the comparison of their counts with the card's."""
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
GATHER, REDUCE = "all_gather_into_tensor", "all_reduce"


def test_sharded_serve_reduced_lists_every_cut():
    """4 prompts of 2048 tokens into 4096 slots, for both serving cells."""
    assert chip_smoke.sharded_serve_reduced() == {
        "prefill_32k": {"seq_len": [32768, 4096], "prompt_len": [32768, 2048],
                        "global_batch": [32, 4]},
        "decode_32k": {"seq_len": [32768, 4096], "global_batch": [128, 4]}}


def _call(ctr, mac, gathers, nbytes, wall=6.0):
    return dict(wall_s=wall, ctr=ctr, mac=mac, collectives={
        GATHER: dict(calls=gathers, s=wall - 1, bytes=nbytes),
        REDUCE: dict(calls=1, s=0.001, bytes=4)})


def _rank(r):
    decode = [_call(184, 12, 14, 6_381_240_320, 6.0 + i / 10)
              for i in range(chip_smoke.PAR_SV_STEPS)]
    train = [_call(539, 72, 37, 6_602_096_640, 9.0) for _ in range(3)]
    for st in train:
        st["collectives"][REDUCE] = dict(calls=8, s=1.0, bytes=806_019_084)
    return {"rank": r,
            "sharded": {"steps": train, "peak_bytes": 34 * 2 ** 30},
            "sharded_serve": dict(
                prefill=_call(26, 12, 12, 5_039_063_040, 5.0), decode=decode,
                launches={}, peak_bytes=12 * 2 ** 30, held_bytes=3 * 10 ** 9,
                whole_bytes=6 * 10 ** 9, tokens_equal=True, logit_diff=0.0,
                block_changed=r == 1, tamper_nan=True)}


def _rows():
    def row(gathers, nbytes, reduces, rbytes, ctr, mac):
        return {"status": "ok", "ctr_launches": ctr, "mac_launches": mac,
                "peak_bytes_per_device": 13e9,
                "collectives": {"all-gather": {"count": gathers,
                                               "bytes": float(nbytes)},
                                "all-reduce": {"count": reduces,
                                               "bytes": float(rbytes)}}}
    return {"serve prefill": row(12, 5_039_063_040, 1, 4, 26, 12),
            "serve decode step": row(14, 6_381_240_320, 1, 4, 184, 12),
            "sharded train step": row(37, 6_602_096_640, 8, 806_019_084,
                                      539, 72)}


def test_dry_run_counts_against_the_card():
    ranks = [_rank(r) for r in range(2)]
    got = chip_smoke.dryrun_against_card(_rows(), ranks)
    assert set(got) == {"serve prefill", "serve decode step",
                        "sharded train step"}
    assert all(chip_smoke._counts_equal(c) for c in got.values())
    assert got["serve decode step"]["collectives"]["all-gather"] == [
        14, [14], 6_381_240_320.0, [6_381_240_320]]
    assert got["sharded train step"]["ctr"] == [539, [539]]
    # a card call that differs, and an operation only the dry run makes
    ranks[1]["sharded_serve"]["decode"][3]["mac"] = 13
    rows = _rows()
    rows["serve prefill"]["collectives"]["reduce-scatter"] = {"count": 1,
                                                              "bytes": 8.0}
    got = chip_smoke.dryrun_against_card(rows, ranks)
    assert got["serve decode step"]["mac"] == [12, [12, 13]]
    assert not chip_smoke._counts_equal(got["serve decode step"])
    assert got["serve prefill"]["collectives"]["reduce-scatter"] == [
        1, [0], 8.0, [0]]
    assert not chip_smoke._counts_equal(got["serve prefill"])
    assert chip_smoke._counts_equal(got["sharded train step"])


def test_sharded_serve_lines_parse(capsys):
    ranks = [_rank(r) for r in range(2)]
    par = {"ranks": ranks,
           "serve_one_process": dict(prefill_s=1.0, decode_s=[0.2, 0.3],
                                     peak_bytes=13 * 2 ** 30),
           "dryrun_check": chip_smoke.dryrun_against_card(_rows(), ranks),
           "dryrun_s": 22.0, "parent_reserved_bytes": 3 * 2 ** 30}
    chip_smoke.print_sharded_serve(par, CARD)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "sharded serve rank 0", "sharded serve rank 1",
        "dry run against the card (launch/dryrun.py on the meta device, "
        "fake group of 2, per call; [dry run, card])"]
    assert all(ln.endswith(CARD) for ln in lines)
    cuts = re.search(r"\(reduced (\{.*?\})\); prefill", lines[0])
    assert json.loads(cuts.group(1)) == chip_smoke.sharded_serve_reduced()
    assert "decode 6.000-7.500 s a step" in lines[0]
    assert "launches (ctr, mac) prefill (26, 12), a decode step " \
        "[(184, 12)]" in lines[0]
    assert "tokens equal to one process's True (17 x 4), largest logit " \
        "difference 0.0" in lines[1]
    assert "its cache block changed by the decode steps False" in lines[0]
    assert "its cache block changed by the decode steps True" in lines[1]
    assert "NaN logits True" in lines[1]
    gloo = re.search(r"decode step 0 (\{.*?\}); launches", lines[0])
    assert json.loads(gloo.group(1)) == {GATHER: [14, 5.0, 6_381_240_320],
                                         REDUCE: [1, 0.001, 4]}
    check = json.loads(re.search(r"card\]\): (\{.*\}); dry run",
                                 lines[2]).group(1))
    assert check["sharded train step"]["mac"] == [72, [72]]
    assert "the parent held 3.00 GiB of the card while the ranks ran" \
        in lines[2]
