"""ctypes bridge to the native C++ graph builder (`native/graphbuild.cpp`),
the counterpart of `gemnet_pytorch_tpu/data/native.py`.

The source compiles with g++ at first use into `_build/` beside the package,
as `ops/_cuda.py` builds the kernels: the library's name carries a digest of
the source, the flags and what `-march=native` resolves to on this host, so
an edited source or another CPU never loads a stale library; it is written
under a temporary name and moved into place with `os.replace`, so processes
building at once never load a partial file. There is no fallback: a failed
build or load raises a RuntimeError that carries g++'s output
(`graph.build_graph_numpy`, the numpy builder, is only the reference).

A ctypes call releases the GIL, so builds in the data provider's prefetch
threads run in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "graphbuild.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


class _GraphResult(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_int64) for n in
         ("n_edges", "n_trip", "n_int_edges", "n_intm_ca", "n_intm_db", "n_quads")]
        + [(n, ctypes.POINTER(ctypes.c_int32)) for n in
           ("id_c", "id_a", "id3_expand", "id3_reduce", "kidx3",
            "int_a", "int_b", "intm_ca", "intm_db", "intm_ab_r", "intm_ab_e",
            "q_reduce", "q_expand", "q_cab", "q_abd", "kidx4")]
    )


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the native graph builder could not run {cmd[0]}: {e}") from e


def library_path() -> Path:
    """The library of this source, these flags and this host's target."""
    target = _run([CXX, "-march=native", "-Q", "--help=target"])
    if target.returncode:
        raise RuntimeError(f"{CXX} -march=native failed:\n{target.stderr}")
    text = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + target.stdout.encode()
    return BUILD_DIR / f"libgraphbuild-{hashlib.sha256(text).hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library where it is missing; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = _run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)])
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed to build the native graph builder:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"the native graph builder {path} failed to load: {e}") from e
            lib.build_graph_native.restype = ctypes.POINTER(_GraphResult)
            lib.build_graph_native.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ]
            lib.free_graph_native.argtypes = [ctypes.POINTER(_GraphResult)]
            lib.free_graph_native.restype = None
            _lib = lib
        return _lib


def _arr(ptr, n) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int32)
    return np.ctypeslib.as_array(ptr, shape=(n,)).copy()


def build_graph_native(R: np.ndarray, N: np.ndarray, cutoff: float, int_cutoff: float,
                       triplets_only: bool) -> dict[str, np.ndarray]:
    """The raw canonical arrays of `graph.build_graph` (JAX
    `data/native.py:86-117`). R (sum(N), 3) positions, N atoms per molecule."""
    lib = _load()
    R = np.ascontiguousarray(R, np.float32)
    N = np.ascontiguousarray(N, np.int64)
    if N.ndim != 1 or (N < 0).any() or R.shape != (int(N.sum()), 3):
        raise ValueError(f"R {R.shape} does not hold the {int(N.sum())} atoms of N")
    res = lib.build_graph_native(
        R.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        N.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(N), float(cutoff), float(int_cutoff), int(triplets_only),
    )
    try:
        g = res.contents
        return dict(
            id_c=_arr(g.id_c, g.n_edges),
            id_a=_arr(g.id_a, g.n_edges),
            id3_expand_ba=_arr(g.id3_expand, g.n_trip),
            id3_reduce_ca=_arr(g.id3_reduce, g.n_trip),
            Kidx3=_arr(g.kidx3, g.n_trip),
            id4_int_a=_arr(g.int_a, g.n_int_edges),
            id4_int_b=_arr(g.int_b, g.n_int_edges),
            id4_reduce_intm_ca=_arr(g.intm_ca, g.n_intm_ca),
            id4_expand_intm_db=_arr(g.intm_db, g.n_intm_db),
            id4_reduce_intm_ab=_arr(g.intm_ab_r, g.n_intm_ca),
            id4_expand_intm_ab=_arr(g.intm_ab_e, g.n_intm_db),
            id4_reduce_ca=_arr(g.q_reduce, g.n_quads),
            id4_expand_db=_arr(g.q_expand, g.n_quads),
            id4_reduce_cab=_arr(g.q_cab, g.n_quads),
            id4_expand_abd=_arr(g.q_abd, g.n_quads),
            Kidx4=_arr(g.kidx4, g.n_quads),
        )
    finally:
        lib.free_graph_native(res)
