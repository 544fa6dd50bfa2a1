"""Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface, ``build/<name>-<hash>.so`` at the repository root, and
loaded with ``ctypes``.  The hash covers the source and the flags, so an
edited source never loads a stale library.  ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` where they run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# per kernel: {"seconds": build wall time (0 when reused), "log": nvcc's
# output, including what -Xptxas -v says of registers and shared memory;
# kept beside the library, so a reused library still has it}
BUILD_INFO: Dict[str, Dict] = {}


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under /usr/local/cuda/bin; raises if neither."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin: "
                       "the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no up-to-date library yet, one ``nvcc`` each, in parallel.  Raises with
    the compiler's output if any build fails."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, out in targets.items():
        if out.exists():
            log = out.with_suffix(".log")
            BUILD_INFO.setdefault(n, {"seconds": 0.0, "log": log.read_text()
                                      if log.exists() else ""})
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[n] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
        else:
            targets[n].with_suffix(".log").write_text(log)
            os.replace(tmp, targets[n])  # atomic: no half-written library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _LIBS[name] = lib
        return lib
