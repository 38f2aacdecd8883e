"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Every source is compiled by ``nvcc`` for ``sm_90a`` into an object, all
of them at once in parallel processes, then linked into ONE shared
library with a plain C interface that is loaded with ``ctypes``. No
PyTorch header is included, so a build takes seconds. The build happens
at first use, from the checkout's sources alone, into ``kernels/_build/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags so a
stale library is never loaded. ``ptxas`` reports each kernel's registers
and shared memory into ``_build/build-<key>.log``.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).with_name("_build")
# no --use_fast_math: kv_quant's bit-exactness needs IEEE division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
# every exported C function: (argtypes), returns cudaGetLastError()
SIGNATURES = {
    "kv_quant_launch": (_P, _I, _P, _P, _P, _LL, _I, _I, _P),
    "kv_dequant_launch": (_P, _P, _P, _P, _I, _LL, _I, _I, _P),
    "kv_quant_append_launch": (_P, _P, _I, _LL, _LL, _LL, _LL, _I, _I, _I,
                               _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I,
                               _P, _I, _P),
    "paged_attention_int4_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _F, _P),
    "paged_attention_int4_occupancy": (_I, _I, _I, _I, _PI, _PI),
    "flash_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _F, _F, _P),
    "rmsnorm_launch": (_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _F,
                       _P),
    "decode_attention_launch": (_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _LL, _LL, _LL, _I, _I, _F,
                                _F, _P),
    "paged_attention_bf16_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _F, _P),
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "kernels are built from kernels/csrc at first use")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile (if needed) and return the path of the shared library."""
    key = build_key()
    lib = BUILD_DIR / f"libkernels-{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        (BUILD_DIR / f"build-{key}.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = pathlib.Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)        # atomic: never a half-written .so
    return lib


def build_log() -> str:
    """The compiler's report (registers, shared memory, spills) of the
    current sources' build; empty if the library was built elsewhere."""
    path = BUILD_DIR / f"build-{build_key()}.log"
    return path.read_text() if path.exists() else ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str):
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
