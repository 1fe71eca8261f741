"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together) and linked into one shared
library with a plain C interface.  The library is built at the first launch
of any kernel, never at import, under ``build/torch_kernels/`` in the
checkout, named by a hash over all the sources: an edit to any source
rebuilds it, an unchanged tree reuses it.  Each kernel's wrapper binds its C
entry point with :func:`function` and loads it with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_ARCH = "arch=compute_90a,code=sm_90a"

_lib = None
_functions: dict = {}


def sources() -> list:
    """The CUDA sources of the library, in a fixed order."""
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("cuda_build: nvcc not found (CUDA_HOME or PATH)")
    return found


def _digest(srcs) -> str:
    h = hashlib.sha256()
    for src in srcs:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile and link every source unless the library for these exact
    sources is already built.  Returns ``{"path", "cached", "seconds",
    "ptxas"}``; ``ptxas`` maps each source's file name to the compiler's
    register / shared-memory / spill report for its kernels."""
    srcs = sources()
    digest = _digest(srcs)
    lib = _BUILD_DIR / f"libtorch_kernels-{digest}.so"
    if lib.exists():
        return {"path": str(lib), "cached": True, "seconds": 0.0, "ptxas": {}}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = [_BUILD_DIR / f"{src.stem}-{tag}.o" for src in srcs]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, "-gencode", _ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(srcs, objs)]
    outs = [proc.communicate() for proc in procs]
    failed = [(src.name, proc.returncode, err)
              for src, proc, (_, err) in zip(srcs, procs, outs)
              if proc.returncode != 0]
    try:
        if failed:
            raise RuntimeError("cuda_build: nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{err}" for name, rc, err in failed))
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"cuda_build: link failed ({link.returncode}):"
                               f"\n{link.stderr}")
        os.replace(tmp, lib)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return {"path": str(lib), "cached": False,
            "seconds": time.perf_counter() - t0,
            "ptxas": {src.name: err.strip()
                      for src, (_, err) in zip(srcs, outs)}}


def function(name: str, argtypes: list):
    """The C entry point ``name`` of the library (built and loaded on first
    use), with its argument types set and an ``int`` result: the CUDA error
    code of the launch, 0 on success."""
    global _lib
    if name not in _functions:
        if _lib is None:
            _lib = ctypes.CDLL(build()["path"])
        fn = getattr(_lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return _functions[name]
