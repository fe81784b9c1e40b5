"""The candidate-verify kernel (K1) of walt_tpu_torch against the JAX one.

- ``verify_windows_reference`` (the plain torch version the wrapper takes on
  CPU tensors) == walt_tpu's Pallas kernel in interpret mode and its jnp
  reference, including the clamp at the genome end and wrapped u32 starts;
- the per-row body ``csrc/verify_row.h``, built with g++, == the plain
  version (the CUDA kernel runs the same body);
- the wrapper refuses what the kernel does not take, and a machine without
  nvcc cannot build the kernel.
"""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walt_tpu.ops import pallas_verify
from walt_tpu_torch import kernels
from walt_tpu_torch.ops import packing, verify


def _inputs(rng, M, W, Wg=400):
    """pseq (Wg,), gpos (M,), conv/lane (M, W) as numpy uint32."""
    pseq = rng.integers(0, 1 << 32, Wg, dtype=np.uint32)
    gpos = rng.integers(0, Wg * 16, M).astype(np.uint32)
    gpos[: min(M, 16)] = (Wg - 1) * 16 + np.arange(min(M, 16))  # clamp region
    if M > 20:
        gpos[16] = (Wg - W) * 16 + 7
        gpos[17:20] = [0x80000000, 0x9000000F, 0xFFFFFFF1]  # wrapped >= 2^31
        gpos[20:] = (gpos[20:] & ~np.uint32(15)) | (np.arange(M - 20) % 16)
    conv = rng.integers(0, 1 << 32, (M, W), dtype=np.uint32)
    lens = rng.integers(0, W * 16 + 1, M)
    lane = np.asarray(packing.len_lane_masks(torch.from_numpy(lens), W))
    return pseq, gpos, conv, lane.astype(np.uint32)


def _torch_args(pseq, gpos, conv, lane, device="cpu"):
    return [packing.from_np(a, device) for a in (pseq, gpos, conv, lane)]


@pytest.mark.parametrize("M,W", [(384, 7), (5, 3), (64, 13), (1000, 63)])
def test_reference_matches_pallas(M, W):
    rng = np.random.default_rng(42 + M)
    pseq, gpos, conv, lane = _inputs(rng, M, W)
    mm, win = verify.verify_windows_reference(
        *_torch_args(pseq, gpos, conv, lane), W)
    mm, win = mm.numpy(), win.numpy().view(np.uint32)

    # the JAX entry point (XLA gather + Pallas kernel, interpret mode)
    mm_p, win_p = pallas_verify.verify_windows(
        jnp.asarray(pseq), jnp.asarray(gpos), jnp.asarray(conv),
        jnp.asarray(lane), W=W, interpret=True)
    np.testing.assert_array_equal(mm, np.asarray(mm_p))
    np.testing.assert_array_equal(win, np.asarray(win_p))

    # the pre-gathered kernel and its jnp oracle
    word0 = (gpos >> 4).astype(np.int64)
    slices = pseq[np.minimum(word0[:, None] + np.arange(W + 1), len(pseq) - 1)]
    shift = ((gpos & 15) << 1).astype(np.uint32)
    args = tuple(map(jnp.asarray, (slices, shift, conv, lane)))
    for fn in (lambda *a: pallas_verify.verify_flat(*a, W=W, interpret=True),
               lambda *a: pallas_verify.verify_flat_reference(*a, W=W)):
        mm_j, win_j = fn(*args)
        np.testing.assert_array_equal(mm, np.asarray(mm_j))
        np.testing.assert_array_equal(win, np.asarray(win_j))


_SHIM = r"""
#include "verify_row.h"
extern "C" void verify_rows(const uint32_t* pseq, int64_t n_pseq,
                            const uint32_t* gpos, const uint32_t* conv,
                            const uint32_t* lane, int64_t M, int W,
                            int32_t* mm, uint32_t* win) {
  for (int64_t m = 0; m < M; ++m)
    waltx::verify_row(pseq, n_pseq, gpos[m], conv + m * W, lane + m * W, W,
                      mm + m, win + m * W);
}
"""


@pytest.fixture(scope="module")
def row_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    d = tmp_path_factory.mktemp("verify_row")
    src, so = d / "shim.cpp", d / "libverify_row.so"
    src.write_text(_SHIM)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-I", kernels.CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.verify_rows.argtypes = [p, ctypes.c_int64, p, p, p, ctypes.c_int64,
                                ctypes.c_int, p, p]
    lib.verify_rows.restype = None
    return lib


@pytest.mark.parametrize("M,W", [(777, 7), (300, 1), (90, 63)])
def test_row_body_gxx_matches_reference(row_lib, M, W):
    rng = np.random.default_rng(7 + M)
    pseq, gpos, conv, lane = _inputs(rng, M, W)
    mm = np.empty(M, np.int32)
    win = np.empty((M, W), np.uint32)
    row_lib.verify_rows(pseq.ctypes.data, len(pseq), gpos.ctypes.data,
                        conv.ctypes.data, lane.ctypes.data, M, W,
                        mm.ctypes.data, win.ctypes.data)
    mm_r, win_r = verify.verify_windows_reference(
        *_torch_args(pseq, gpos, conv, lane), W)
    np.testing.assert_array_equal(mm, mm_r.numpy())
    np.testing.assert_array_equal(win, win_r.numpy().view(np.uint32))


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(11)
    pseq, gpos, conv, lane = _torch_args(*_inputs(rng, 8, 3))
    with pytest.raises(TypeError):
        verify.verify_windows(pseq, gpos.to(torch.int64), conv, lane, 3)
    with pytest.raises(ValueError):
        verify.verify_windows(pseq, gpos, conv[:, :2], lane, 3)
    with pytest.raises(ValueError):
        verify.verify_windows(pseq, gpos, conv.t().contiguous().t(), lane, 3)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        verify.verify_windows(*(t.to("meta") for t in
                                (pseq, gpos, conv, lane)), 3)


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without nvcc the kernel library cannot be built, and asking for it
    raises instead of handing back anything else."""
    monkeypatch.setenv("PATH", os.defpath)
    monkeypatch.setenv("CUDA_HOME", "")
    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "LIB_PATH", "/nonexistent/libk.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.library()


@pytest.mark.parametrize("checkout", [True, False])
def test_kernel_build_dir(tmp_path, monkeypatch, checkout):
    """A checkout builds the kernels under its own build/; an installed copy
    (no pyproject.toml beside the package) builds in the user's cache."""
    import importlib.util

    root = tmp_path / "site"
    (root / "walt_tpu_torch").mkdir(parents=True)
    if checkout:
        (root / "pyproject.toml").write_text("")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    spec = importlib.util.spec_from_file_location(
        "kernels_copy", root / "walt_tpu_torch" / "kernels.py")
    mod = importlib.util.module_from_spec(spec)
    (root / "walt_tpu_torch" / "kernels.py").write_text(
        open(kernels.__file__).read())
    spec.loader.exec_module(mod)
    want = (root / "build" / "kernels" if checkout else
            tmp_path / "home" / ".cache" / "walt_tpu_torch" / "kernels")
    assert mod.BUILD_DIR == str(want)
    assert os.path.dirname(mod.LIB_PATH) == str(want)
