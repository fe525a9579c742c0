"""Build + ctypes loader for the native polytope engine.

The engine's source is the JAX package's
``bensolve_tpu/native/poly_engine.cpp``, read by path (not copied, and
without importing that package).  It is compiled with the system g++ on
first use into this package's ``_build/`` directory (rebuilt whenever
the source is newer).  When no working toolchain is available the
package degrades gracefully: ``lib()`` returns None and the
pure-Python engine in bensolve_tpu_torch.poly.polytope is used instead.
This is host code: the polytope engine never runs on the device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "bensolve_tpu",
                    "native", "poly_engine.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD, "_poly_engine.so")

_lib = None
_tried = False


def _build() -> bool:
    try:
        if not os.path.exists(_SRC):
            return False
        if (os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
            return True
        os.makedirs(_BUILD, exist_ok=True)
        # build into a temp file then atomically rename, so concurrent
        # test workers never load a half-written .so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
               _SRC, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            os.unlink(tmp)
            return False
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _bind(so: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    dp = c.c_void_p
    so.poly_new.restype = dp
    so.poly_new.argtypes = [c.c_int]
    so.poly_delete.argtypes = [dp]
    so.poly_set_dual.argtypes = [dp, dp]
    so.poly_bind.argtypes = [dp, c.c_void_p, c.c_void_p, c.c_int,
                             c.c_void_p, c.c_void_p, c.c_void_p, c.c_int]
    so.poly_cnt.restype = c.c_int
    so.poly_cnt.argtypes = [dp]
    so.poly_set_cnt.argtypes = [dp, c.c_int]
    so.poly_append.restype = c.c_int
    so.poly_append.argtypes = [dp]
    so.poly_row_len.restype = c.c_int
    so.poly_row_len.argtypes = [dp, c.c_int, c.c_int]
    so.poly_row_get.argtypes = [dp, c.c_int, c.c_int, c.c_void_p]
    so.poly_row_set.argtypes = [dp, c.c_int, c.c_int, c.c_void_p, c.c_int]
    so.poly_row_append.argtypes = [dp, c.c_int, c.c_int, c.c_int]
    so.poly_nnz.restype = c.c_int64
    so.poly_nnz.argtypes = [dp, c.c_int]
    so.poly_csr.argtypes = [dp, c.c_int, c.c_void_p, c.c_void_p]
    so.poly_csr_load.argtypes = [dp, c.c_int, c.c_void_p, c.c_void_p,
                                 c.c_int]
    so.poly_edge_test.restype = c.c_int
    so.poly_edge_test.argtypes = [dp, c.c_int, c.c_int]
    so.poly_wire_new_facet.argtypes = [dp, c.c_int]
    so.poly_update_adjacency.argtypes = [dp]
    so.poly_count_missing_adj.restype = c.c_int64
    so.poly_count_missing_adj.argtypes = [dp]
    so.poly_cut.restype = c.c_int
    so.poly_cut.argtypes = [dp, c.c_int, c.c_void_p, c.c_double]
    return so


def lib() -> ctypes.CDLL | None:
    """The loaded engine, or None when unavailable.  Set
    BENSOLVE_TPU_NO_NATIVE=1 to force the pure-Python engine."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("BENSOLVE_TPU_NO_NATIVE"):
        return None
    if _build():
        try:
            _lib = _bind(ctypes.CDLL(_SO))
        except OSError:
            _lib = None
    return _lib
