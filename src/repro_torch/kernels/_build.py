"""Build and load the hand-written CUDA kernels at first use.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C entry point, in ``build/kernels/``
at the root of the checkout, and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  A library's file name carries a hash
of its source and flags, so an edited source is rebuilt and an unchanged
one is reused across processes.

Nothing is built at import time.  ``library(name)`` builds on first call;
``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them.  A ``threading.Lock`` serializes first use within a process (the
suggestion pumps and the fit-executor workers can all get there together)
and a file lock in the build directory serializes it across processes
(parallel test workers).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gp_nll", "gp_ei", "flash_attention", "rglru_scan", "int8_quant",
           "adamw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 when reused)
build_seconds: Dict[str, float] = {}
#: what ``-Xptxas -v`` reported for each library built in this process
ptxas_report: Dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else the toolkit
    PyTorch itself located."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on the machine with the card")


def tool(name: str) -> str:
    """Path of a CUDA toolkit program (``cuobjdump``, ...) beside nvcc."""
    path = pathlib.Path(nvcc()).with_name(name)
    if not path.exists():
        raise RuntimeError(f"{name} not found beside {nvcc()}")
    return str(path)


def library_path(name: str) -> pathlib.Path:
    """The shared library built from ``csrc/<name>.cu`` with this
    package's flags (built or not)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _build_missing(names: List[str]) -> None:
    """Compile every missing library, one nvcc process per source, all
    started together.  Caller holds both locks."""
    todo = [n for n in names if not library_path(n).exists()]
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        ptxas_report[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def build_all(names=SOURCES) -> Dict[str, ctypes.CDLL]:
    """Build (where needed) and load every named kernel library."""
    names = list(names)
    with _LOCK:
        missing = [n for n in names if n not in _LIBS]
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / ".lock", "w") as fh:
                fcntl.flock(fh, fcntl.LOCK_EX)
                try:
                    _build_missing(missing)
                finally:
                    fcntl.flock(fh, fcntl.LOCK_UN)
            for name in missing:
                build_seconds.setdefault(name, 0.0)
                _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return {n: _LIBS[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all([name])[name]
