"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Every ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``csrc/build/lib<name>-<hash>.so`` (the hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so a changed source never loads
a stale library). Building happens
at first use; ``build_all()`` starts one nvcc per source, all at once.
Nothing here runs when a module is imported: the CPU tests import every
module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
# --split-compile=0: nvcc optimizes a source's device code on every core
# (the three sources build in less than half the time; PERF.md §4)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels of this "
                           "package are built on a machine with the CUDA "
                           "toolkit")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    # the report goes to a file: a pipe that nobody reads while another
    # nvcc is awaited fills up and stalls this one
    with open(f"{tmp}.log", "w") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)


def _finish(name: str, proc) -> None:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc.wait()
    report = Path(f"{tmp}.log")
    log = report.read_text()
    report.unlink()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> Dict[str, str]:
    """Compile every source in parallel; returns {name: nvcc log}."""
    procs = {n: _start(n) for n in sources()}
    errors = []
    for n, p in procs.items():
        if p is not None:
            try:
                _finish(n, p)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    logs = {}
    for n in procs:
        log = _target(n).with_suffix(".log")
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            p = _start(name)
            if p is not None:
                _finish(name, p)
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib
