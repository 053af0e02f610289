"""The port's copy of the paper's cycle model (``core/overhead.py``,
``accel/``) against the reference, and the H100 model that prices sealed
bytes in the port's cost ledger and profiler.

Exactly equal, not within a tolerance: the same Python arithmetic on the
same constants.  Every Table 1 row through ``table_row``; ``simulate``,
``slowdown`` and ``crypto_cycles`` on the cases of
``tests/test_vta_overhead.py``, with the reference's accelerator model
built here from ``repro.core.overhead`` (the port keeps no copy of it);
``CostLedger.reconcile`` rows from both packages for one model and clock.
"""
import dataclasses

import pytest

from repro.accel import VTAConfig as JVTAConfig
from repro.accel import vta_sim as jvta
from repro.accel import workloads as jworkloads
from repro.core import overhead as joverhead
from repro.core.policy import Protection as JProtection
from repro.obs.costs import CostLedger as JCostLedger

pytest.importorskip("torch")

from repro_torch.accel import VTAConfig, vta_sim, workloads  # noqa: E402
from repro_torch.core import overhead  # noqa: E402
from repro_torch.core.policy import Protection  # noqa: E402
from repro_torch.obs import Profiler  # noqa: E402
from repro_torch.obs.costs import CostLedger  # noqa: E402

PROTECTIONS = ("NONE", "CTR", "TRUSTED")


def _port_model(jmodel):
    """The reference's accelerator model as the port's dataclass."""
    return overhead.AcceleratorModel(**dataclasses.asdict(jmodel))


def _workload(jw):
    return overhead.Workload(jw.name, jw.flops, jw.bytes_read,
                             jw.bytes_written)


@pytest.mark.parametrize("name", [w.name for w in jworkloads.TABLE1])
def test_table1_rows_equal_reference(name):
    jw = next(w for w in jworkloads.TABLE1 if w.name == name)
    w = next(w for w in workloads.TABLE1 if w.name == name)
    assert dataclasses.asdict(w) == dataclasses.asdict(jw)
    assert vta_sim.table_row(VTAConfig(), w) == jvta.table_row(JVTAConfig(),
                                                               jw)
    assert workloads.PAPER_TABLE1[name] == jworkloads.PAPER_TABLE1[name]


@pytest.mark.parametrize("scheme", ["gfm", "tree"])
@pytest.mark.parametrize("prot", PROTECTIONS)
def test_simulate_equals_reference(scheme, prot):
    for jw, w in zip(jworkloads.TABLE1, workloads.TABLE1):
        got = vta_sim.simulate(VTAConfig(mac_scheme=scheme), w,
                               Protection[prot])
        want = jvta.simulate(JVTAConfig(mac_scheme=scheme), jw,
                             JProtection[prot])
        assert got == want, w.name


def _models():
    """The cases of tests/test_vta_overhead.py: the reference's default
    model and its serial and pipelined ones."""
    return {"reference": joverhead.TPU_V5E,
            "serial": joverhead.AcceleratorModel("s", 256, 8, 16, 29, 8.0,
                                                 mac_pipelined=False),
            "pipelined": joverhead.AcceleratorModel("p", 256, 8, 16, 29, 8.0,
                                                    mac_pipelined=True)}


@pytest.mark.parametrize("model", ["reference", "serial", "pipelined"])
def test_slowdown_and_crypto_cycles_equal_reference(model):
    jm = _models()[model]
    m = _port_model(jm)
    cases = [("gemv", 1, 4096, 4096), ("gemm", 512, 4096, 4096),
             ("fc", 1, 4096, 9216)]
    for name, a, b, c in cases:
        jw = joverhead.gemm_workload(name, a, b, c)
        w = overhead.gemm_workload(name, a, b, c)
        assert dataclasses.asdict(w) == dataclasses.asdict(jw)
        for prot in PROTECTIONS:
            assert m.slowdown(w, Protection[prot]) == jm.slowdown(
                jw, JProtection[prot])
            assert m.step_cycles(w, Protection[prot]) == jm.step_cycles(
                jw, JProtection[prot])
    jc = joverhead.conv2d_workload("c", 56, 56, 64, 64, 3, 3)
    c = overhead.conv2d_workload("c", 56, 56, 64, 64, 3, 3)
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    for n in (0, 1, 16, 2048, 1 << 20, 3 * (1 << 20) + 5):
        for enc in (False, True):
            for auth in (False, True):
                assert m.crypto_cycles(n, enc, auth) == jm.crypto_cycles(
                    n, enc, auth)


def _charge(ledger):
    ledger.charge("decode", "a", 4096, "decode")
    ledger.charge("close", "a", 65536, "decode")
    ledger.charge("swap_out", "b", 131072, "swap")
    ledger.time("decode", "a", 812.5, dispatches=3)
    ledger.time("close", "a", 40.0)
    ledger.time("swap_out", "b", 1500.0, dispatches=1)
    ledger.time("prefill", "b", 20.0)


def test_reconcile_rows_equal_reference_for_one_model_and_clock():
    jl, tl = JCostLedger(chunk_words=128), CostLedger(chunk_words=128)
    _charge(jl)
    _charge(tl)
    jm = joverhead.TPU_V5E
    for model, jmodel in ((_port_model(jm), jm),
                          (overhead.H100, _jmodel(overhead.H100))):
        for clock in (1e9, 1.98e9):
            assert tl.reconcile(model, clock_hz=clock) == jl.reconcile(
                jmodel, clock_hz=clock)


def _jmodel(m):
    fields = dataclasses.asdict(m)
    fields.pop("clock_hz")
    return joverhead.AcceleratorModel(**fields)


def test_h100_model_prices_bytes_at_the_card_clock():
    m = overhead.H100
    assert m.clock_hz == 1.98e9
    assert m.flops_per_cycle * m.clock_hz == pytest.approx(989e12)
    assert m.dram_bytes_per_cycle * m.clock_hz == pytest.approx(3.35e12)
    # 42 ALU operations a Threefry block of 8 bytes, 14 a MAC word, on
    # 132 x 64 INT32 lanes a cycle
    lanes = 132 * 64
    n = 1 << 20
    assert m.crypto_cycles(n, True, False) == pytest.approx(n / 8 * 42 / lanes)
    assert m.crypto_cycles(n, False, True) == pytest.approx(n / 4 * 14 / lanes)
    assert m.slowdown(overhead.gemm_workload("gemv", 1, 4096, 4096, 2),
                      Protection.TRUSTED) > m.slowdown(
        overhead.gemm_workload("gemm", 4096, 4096, 4096, 2),
        Protection.TRUSTED) == 1.0


def test_reconcile_and_report_default_to_the_h100_model():
    prof = Profiler(chunk_words=128)
    _charge(prof.ledger)
    rows = prof.ledger.reconcile()
    assert rows == prof.ledger.reconcile(overhead.H100, clock_hz=1.98e9)
    doc = prof.report()
    assert doc["model"] == "h100-sealed"
    assert doc["phases"] == rows
    decode = next(r for r in rows if r["phase"] == "decode")
    assert decode["predicted_us"] == pytest.approx(
        1e6 * overhead.H100.crypto_cycles(4096) / 1.98e9)
    with pytest.raises(ValueError):
        prof.ledger.reconcile(_port_model(_models()["serial"]))
