"""Build and load the CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``. The library lands in ``_build/`` next
to this package (listed in ``.gitignore``), named by a hash of the source,
the shared headers ``csrc/*.cuh`` and the flags, so an edited source or
header rebuilds and an unchanged one is reused. Nothing builds at import:
the first launch of a kernel builds its library, and :func:`build_all`
builds every source in parallel (one ``nvcc`` each).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("pack", "bmm", "bspmm", "bspmm_grid", "fused_layer", "fused_pair")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# argtypes of every exported function: pointers and the stream as c_void_p
SIGNATURES = {
    "pack": {"binarize_pack_f32": (_P, _P, _L, _I, _I, _P),
             "binarize_pack_bf16": (_P, _P, _L, _I, _I, _P)},
    "bmm": {"bmm_xnor": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
            "bmm_xnor_attrs": (_I, _I, _P)},
    "bspmm": {"bspmm_bits": (_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _L, _L, _I, _I, _I, _I, _P),
              "bspmm_bits_attrs": (_I, _I, _P),
              "bspmm_fp": (_P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _L, _L, _I, _I, _I, _I, _P),
              "bspmm_fp_attrs": (_I, _I, _I, _P)},
    "bspmm_grid": {"bspmm_bits_grid": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _L, _I, _I, _L, _I, _I, _I, _I, _P),
                   "bspmm_bits_grid_attrs": (_I, _I, _P),
                   "bspmm_fp_grid": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _L,
                                     _I, _I, _I, _I, _L, _I, _I, _I, _I, _P),
                   "bspmm_fp_grid_attrs": (_I, _I, _I, _P)},
    "fused_layer": {"fused_layer": (_P, _P),
                    "fused_layer_attrs": (_I, _I, _I, _P),
                    "fused_fc": (_P, _P),
                    "fused_fc_attrs": (_I, _P)},
    "fused_pair": {"fused_pair": (_P, _P),
                   "fused_pair_fp_attrs": (_I, _I, _I, _P),
                   "fused_pair_bits_attrs": (_I, _I, _P)},
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch build on a machine with the "
                       "CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, temporary output, final path)."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees a partial file


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load the named libraries."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        started = [(n, *_start(n)) for n in todo]
        try:
            for n, proc, tmp, out in started:
                _finish(n, proc, tmp, out)
        finally:
            for _, proc, _, _ in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n, _, _, out in started:
            _LIBS[n] = _load(n, out)
        return {n: _LIBS[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built on first use."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all([name])[name]


def attributes(name: str, fn: str, *layout: int) -> Dict[str, int]:
    """Registers a thread, static shared bytes, resident blocks per SM and
    dynamic shared bytes of a kernel, from its library's ``<fn>_attrs``
    query (``cudaFuncGetAttributes`` and the occupancy calculator, 256
    threads a block); a query that sets no dynamic size reports 0."""
    out = (ctypes.c_int * 4)()
    check(getattr(library(name), f"{fn}_attrs")(*layout, out), f"{fn}_attrs")
    return {"registers": out[0], "static_smem_bytes": out[1],
            "blocks_per_sm": out[2], "dynamic_smem_bytes": out[3]}


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {status}")
