"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference loads nothing of the port."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {bench!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level_after(body: str) -> set:
    code = PROBE.format(src=str(ROOT / "src"), bench=str(ROOT / "bench"),
                        body=body)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_and_readers_load_no_jax():
    body = """
from pathlib import Path
from benchlib import harness, profiling, readers, reference, traffic
from benchlib.cell import Cell
root = Path.cwd()
spec = json.loads((root / "BENCHMARK.json").read_text())
for w in spec["workloads"]:
    cell = Cell.load(root, w["name"])
    cell.driver()
    for m in cell.per_layer():
        cell.reader(m["name"])
import repro_torch.serve, repro_torch.train, repro_torch.launch.steps
"""
    mods = _top_level_after(body)
    assert not mods & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in mods


def test_reference_loads_nothing_of_the_port():
    body = """
from benchlib import reference, traffic, weights, yardstick
"""
    mods = _top_level_after(body)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_harness_reads_nothing_of_the_jax_benchmarks():
    for path in (ROOT / "bench").rglob("*.py"):
        text = path.read_text()
        for word in ("benchmarks/", "BENCH_", "import jax", "from repro ",
                     "from repro.", "import repro\n"):
            if path.name == "test_bench_imports.py":
                continue
            assert word not in text, (path, word)


@pytest.mark.parametrize("name", ["jax", "repro"])
def test_the_forbidden_check_compares_whole_names(name, monkeypatch):
    from benchlib import harness
    monkeypatch.setitem(sys.modules, name + ".fake", object())
    assert name in harness.loaded_forbidden()
    monkeypatch.delitem(sys.modules, name + ".fake")
    assert "repro" not in harness.loaded_forbidden() or \
        "repro" in {m.split(".")[0] for m in sys.modules}


@pytest.mark.parametrize("loads", [None, "jax", "repro"])
def test_a_module_that_the_check_loads_withholds_the_result(loads,
                                                            monkeypatch):
    """The look at sys.modules comes after the check and the readers: a
    check that loads JAX or the JAX package leaves no result line."""
    import time
    import types

    from benchlib import harness

    class Driver:
        check_s, setup_parts = 0.0, {}

        def setup(self):
            pass

        def window(self, seconds, holder):
            return {"tok_s": 1.0}

        def layer_context(self):
            return {}

        def release(self):
            pass

        def check(self):
            if loads:
                monkeypatch.setitem(sys.modules, loads,
                                    types.ModuleType(loads))
            return [harness.Check("gap", 0.0, 1.0)], 1, 0

    class FakeCell:
        def driver(self):
            return types.SimpleNamespace(make=lambda cell, ctx: Driver())

        def end_to_end(self):
            return [{"name": "tok_s", "unit": "tokens/s"},
                    {"name": "setup_s", "unit": "s"}]

    ctx = harness.Ctx(seed=1, seconds=0.0, trace=False, device="cpu")
    rc, out = harness.run(FakeCell(), ctx, time.monotonic())
    if loads is None:
        assert rc == 0 and out["correct"]
        assert list(out)[-1] == "checks"
    else:
        assert rc != 0 and out is None
