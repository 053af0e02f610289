"""The port stands alone: importing it, its examples (``examples/*_torch.py``)
or its tools (``tools/*_torch.py``) loads neither jax nor ``repro``."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the modules of each slice, which the walk below must reach
SLICE_MODULES = (
    "repro_torch.serve.engine", "repro_torch.launch.serve",
    "repro_torch.kernels.sealed_matmul.ops",
    "repro_torch.kernels.sealed_matmul.ref", "repro_torch.optim.adamw",
    "repro_torch.optim.schedule", "repro_torch.data.pipeline",
    "repro_torch.train.trainer", "repro_torch.train.checkpoint",
    "repro_torch.train.fault", "repro_torch.launch.train",
    "repro_torch.models.registry", "repro_torch.models.rwkv",
    "repro_torch.models.ssm", "repro_torch.configs.qwen3_4b",
    "repro_torch.configs.minitron_8b", "repro_torch.configs.internvl2_2b",
    "repro_torch.configs.rwkv6_3b", "repro_torch.configs.zamba2_1_2b",
    "repro_torch.models.moe", "repro_torch.models.encdec",
    "repro_torch.configs.moonshot_v1_16b_a3b",
    "repro_torch.configs.llama4_maverick_400b_a17b",
    "repro_torch.configs.seamless_m4t_large_v2",
    "repro_torch.launch.steps", "repro_torch.parallel.compress",
    "repro_torch.parallel.collectives", "repro_torch.configs.llama3_405b",
    "repro_torch.launch.mesh", "repro_torch.parallel.sharding",
    "repro_torch.parallel.pipeline", "repro_torch.models.moe_ep",
    "repro_torch.core.overhead", "repro_torch.accel.vta_sim",
    "repro_torch.accel.workloads", "repro_torch.launch.dryrun",
    "repro_torch.kernels.scan",
    "repro_torch.kernels.wkv6_scan.ops", "repro_torch.kernels.wkv6_scan.ref",
    "repro_torch.kernels.ssd_scan.ops", "repro_torch.kernels.ssd_scan.ref")

# the port's user entry points outside src/: the examples and the tools
ENTRY_POINTS = ("examples/quickstart_torch.py",
                "examples/secure_serving_torch.py",
                "examples/secure_training_torch.py",
                "examples/multipod_training_torch.py",
                "tools/verify_audit_torch.py", "tools/obs_dash_torch.py",
                "tools/trace2perfetto_torch.py")

PROBE = """
import glob, importlib.util, os, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(m.name)
root = %r
scripts = sorted(glob.glob(os.path.join(root, "examples", "*_torch.py"))
                 + glob.glob(os.path.join(root, "tools", "*_torch.py")))
for path in scripts:
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
missing = [m for m in %r if m not in sys.modules]
missing += [p for p in %r if os.path.join(root, p) not in scripts]
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "repro" or n.startswith("repro."))
print("LOADED", bad, "MISSING", missing)
sys.exit(1 if bad or missing else 0)
""" % (str(ROOT), SLICE_MODULES, ENTRY_POINTS)


def test_port_imports_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED [] MISSING []" in proc.stdout


def test_port_sources_never_name_jax_or_the_reference():
    paths = [*(ROOT / "src" / "repro_torch").rglob("*.py"),
             *(ROOT / "examples").glob("*_torch.py"),
             *(ROOT / "tools").glob("*_torch.py")]
    assert len(paths) > len(ENTRY_POINTS)
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "jaxlib",
                                                      "repro"), (path, line)
