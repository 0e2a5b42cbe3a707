"""Builds the CUDA sources under ``uurg_torch/csrc/`` at first use.

Each ``<name>.cu`` exports plain C functions and is compiled by ``nvcc`` on
its own into ``build/uurg_torch_kernels/<name>-<hash>.so`` (the hash covers
the source, the shared ``*.cuh`` headers beside it and the flags, so an
edited source rebuilds), then loaded with ``ctypes``. All missing libraries
are compiled at once, one ``nvcc`` process per source (``build_logs`` and
``build_seconds`` keep each one's output and wall time). A failed build
raises; nothing falls back.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "uurg_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}
build_logs: dict[str, str] = {}   # nvcc output (ptxas register/spill report)
build_seconds: dict[str, float] = {}   # each nvcc's wall time


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the uurg_torch kernels (set CUDA_HOME or PATH)")


def _target(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_all() -> None:
    """Compile every source whose library is missing, all in parallel."""
    with _lock:
        todo = [(s, _target(s)) for s in sources() if not _target(s).exists()]
        if not todo:
            return
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        t0 = time.monotonic()
        for src, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))

        def reap(src, proc):
            build_logs[src.stem] = proc.communicate()[0]
            build_seconds[src.stem] = time.monotonic() - t0

        reapers = [threading.Thread(target=reap, args=(src, proc))
                   for src, _, _, proc in procs]
        for r in reapers:
            r.start()
        for r in reapers:
            r.join()
        failed = []
        for src, out, tmp, proc in procs:
            log = build_logs[src.stem]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src.name} "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        build_all()
        lib = _libs[name] = ctypes.CDLL(str(_target(src)))
    return lib


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu`` with its argument types declared and
    an int (the CUDA error code) as its result; bound once per process."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn
