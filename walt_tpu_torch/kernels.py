"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc``, one process per
source, all started together, and linked into one shared library with a
plain C interface (``build/kernels/libwaltx_torch_kernels.so`` at the
repository root when run from a checkout, else under
``~/.cache/walt_tpu_torch/kernels/``), at first use and again whenever a
source is newer than the library, and loaded with ``ctypes``.  Pointers and
the stream are passed as ``c_void_p``; each entry point launches on the
stream it is given and returns ``cudaGetLastError()``.

Nothing is built or loaded at import time: a machine without ``nvcc`` (or
without a GPU) imports this module freely and only :func:`library` fails.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = [os.path.join(CSRC, "verify.cu"),
           os.path.join(CSRC, "verify_stage.cu")]
HEADERS = [os.path.join(CSRC, "verify_row.h"),
           os.path.join(CSRC, "verify_stage_row.h"),
           os.path.join(CSRC, "device_guard.h")]
_ROOT = os.path.dirname(_PKG)
# a checkout builds beside its sources; an installed copy must not write
# into site-packages, so it builds in the user's cache
BUILD_DIR = (
    os.path.join(_ROOT, "build", "kernels")
    if os.path.isfile(os.path.join(_ROOT, "pyproject.toml"))
    else os.path.join(os.path.expanduser("~"), ".cache", "walt_tpu_torch",
                      "kernels")
)
LIB_PATH = os.path.join(BUILD_DIR, "libwaltx_torch_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(root, "bin", "nvcc") if root else ""
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile the kernels if the library is missing or stale.

    Every source compiles in its own nvcc process, all at once, into an
    object file; one more nvcc links them.  Returns the compilers'
    diagnostic output (``-Xptxas=-v`` register and spill counts), or an
    empty string when the library was up to date.
    """
    newest = max(os.path.getmtime(p) for p in SOURCES + HEADERS)
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest:
        return ""
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
            for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-I", CSRC, "-c", "-o", obj,
             src] for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    log = []
    try:
        for cmd, proc in zip(cmds, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{err}")
            log.append(err)
        tmp = f"{LIB_PATH}.{tag}"
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(link)}\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
    return "".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.waltx_verify.argtypes = [
                p, i64, p, p, p, i64, ctypes.c_int, p, p, ctypes.c_int, p,
            ]
            lib.waltx_verify.restype = ctypes.c_int
            lib.waltx_verify_stage.argtypes = [p, ctypes.c_int, p]
            lib.waltx_verify_stage.restype = ctypes.c_int
            lib.waltx_verify_stage_args_size.argtypes = []
            lib.waltx_verify_stage_args_size.restype = ctypes.c_int
            from walt_tpu_torch.ops.verify import StageArgs

            if lib.waltx_verify_stage_args_size() != ctypes.sizeof(StageArgs):
                raise RuntimeError("ops/verify.StageArgs does not match "
                                   "csrc/verify_stage_row.h")
            _lib = lib
    return _lib
