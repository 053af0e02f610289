"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>.so`` with a
plain C interface, for Hopper only (``sm_90a``).  The first call to
``library(name)`` compiles every source at once, one ``nvcc`` process per
file started together, into ``csrc/_build/`` (listed in .gitignore).  A
library is named by a hash of its sources and flags, so an edited source
rebuilds and a finished build is reused.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = ("ctr_cipher", "tree_mac", "sealed_attention", "sealed_matmul",
           "wkv6_scan", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # nvcc's output per source (ptxas -v lines)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).is_file():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every source whose library is missing, all in parallel."""
    todo = [n for n in SOURCES if not _lib_path(n).is_file()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


# the integer opcodes of the Threefry and MAC arithmetic: IADD3, LOP3, SHF,
# LEA and PRMT issue on the ALU pipe, IMAD (any form) on the FMA pipe
ALU_OPCODES = ("IADD3", "LOP3", "SHF", "LEA", "PRMT")
SASS_OPCODES = ALU_OPCODES + ("IMAD",)


def sass(name: str) -> dict[str, list[str]]:
    """The SASS of every kernel of ``lib<name>.so`` (cuobjdump -sass; built
    on first use): {function: [opcode of each instruction, in order]}."""
    library(name)
    tool = Path(_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                         capture_output=True, text=True, check=True).stdout
    return sass_opcodes(out)


def sass_opcodes(text: str) -> dict[str, list[str]]:
    """cuobjdump -sass text -> {function: [opcode, ...]}, each opcode
    without its modifiers or predicate (``@P0 LOP3.LUT ...`` -> LOP3)."""
    funcs: dict[str, list[str]] = {}
    ops = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            ops = funcs.setdefault(line.split(":", 1)[1].strip(), [])
        elif ops is not None and line.startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and words[0][:1].isalpha():
                ops.append(words[0].split(".")[0])
    return funcs


def sass_mix(name: str) -> dict[str, dict[str, int]]:
    """How often each of SASS_OPCODES occurs in the SASS of every kernel of
    ``lib<name>.so``: {function: {opcode: count}}."""
    return {fn: {op: ops.count(op) for op in SASS_OPCODES}
            for fn, ops in sass(name).items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
