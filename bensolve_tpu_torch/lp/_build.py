"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by nvcc into a shared library with
a plain C interface and loaded with ctypes.  The build happens at first
use (never at import), goes into ``bensolve_tpu_torch/_build/`` (listed
in .gitignore), and is redone when the source is newer than the
library.  A failed build raises with nvcc's output; nothing falls back
to a plain version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "lp", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> (ctypes library, seconds the build took or 0.0, nvcc output)
_LOADED: dict = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then PyTorch's idea of the CUDA home, then
    $PATH."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return found


def build(name: str) -> tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>.so`` unless an
    up-to-date library is there.  Returns (path, build seconds, nvcc
    output); seconds is 0.0 when nothing was built."""
    src = os.path.join(CSRC, name + ".cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {src} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    # atomic rename: a concurrent process never loads a half-written .so
    os.replace(tmp, so)
    return so, seconds, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first when needed."""
    hit = _LOADED.get(name)
    if hit is not None:
        return hit[0]
    so, seconds, log = build(name)
    lib = ctypes.CDLL(so)
    _LOADED[name] = (lib, seconds, log)
    return lib


def build_info(name: str) -> tuple[float, str]:
    """(build seconds, nvcc output) of the library ``load`` returned."""
    load(name)
    return _LOADED[name][1], _LOADED[name][2]
