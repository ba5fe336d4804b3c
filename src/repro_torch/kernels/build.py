"""Build the CUDA sources under ``repro_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Builds happen at first use, never at import, into
``REPRO_TORCH_BUILD_DIR`` (default: ``_build/`` beside the package, which
``.gitignore`` lists).  The library's file name carries a hash of its
source, the headers beside it (``csrc/*.cuh``) and the flags, so an edited
source never loads a stale build.
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

__all__ = ["NVCC_FLAGS", "CSRC", "build_dir", "build", "build_all", "load",
           "bind", "build_log"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: per source: (seconds the build took, compiler output); 0.0 s = cached
build_log: dict[str, tuple[float, str]] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only where the CUDA toolkit is installed")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # what the sources include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` (None when the library is built)."""
    src, out = _target(name)
    if out.exists():
        build_log.setdefault(name, (0.0, ""))
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    build_log[name] = (time.perf_counter() - t0, log)


def build_all(names=None) -> dict[str, tuple[float, str]]:
    """Build every source (default: all of ``csrc/*.cu``), one ``nvcc``
    per source, all started together; returns :data:`build_log`."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            _finish(n, s)
    return build_log


def build(name: str) -> Path:
    """Build ``csrc/<name>.cu`` if needed; returns the library's path."""
    with _lock:
        _finish(name, _start(name))
    return _target(name)[1]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libs[name] = lib
    return lib


def bind(name: str, signatures: dict, error_symbol: str) -> dict:
    """The C entry points of ``csrc/<name>.cu`` (built at first use) as a
    dict: ``signatures`` maps a key to ``(symbol, argtypes)`` of a function
    returning a ``cudaError_t`` as int; key ``"error"`` is the library's
    ``cudaGetErrorString``."""
    lib = load(name)
    fns = {}
    for key, (symbol, argtypes) in signatures.items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[key] = fn
    err = getattr(lib, error_symbol)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    fns["error"] = err
    return fns
