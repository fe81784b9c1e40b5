"""Candidate verify (K1): align + compare + fold + count over a worklist.

Port of ``walt_tpu/ops/pallas_verify.py``.  For each worklist row m,
gather the W+1 packed genome words starting at word ``gpos[m] >> 4``,
funnel-shift them into the aligned window ``win[m]`` (W words), and count
the mismatching 2-bit lanes against the converted read words under the
read-length lane mask:

    d = win ^ conv;  mm = sum_j popcount((d | d >> 1) & lane)

:func:`verify_windows` launches the hand-written CUDA kernel
(``csrc/verify.cu``) on CUDA tensors, and takes the plain PyTorch version
:func:`verify_windows_reference` only for tensors on the CPU.  It never
falls back from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from walt_tpu_torch.ops import packing

#: kernel launches made by :func:`verify_windows` (reset by callers that
#: want to show a run went through the kernel)
launches = 0


def verify_windows_reference(pseq, gpos, conv, lane, W: int):
    """Plain PyTorch verify, same arguments and results as
    :func:`verify_windows`; runs on any device."""
    win = packing.window_words(pseq, packing.u32(gpos), W)
    d = win ^ packing.u32(conv)
    mm = packing.popcount32((d | (d >> 1)) & packing.u32(lane)).sum(-1)
    return mm.to(torch.int32), packing.to_i32(win)


def _check(pseq, gpos, conv, lane, W: int) -> None:
    if W < 1:
        raise ValueError(f"verify_windows: W must be >= 1, got {W}")
    for name, t in (("pseq", pseq), ("gpos", gpos), ("conv", conv),
                    ("lane", lane)):
        if t.dtype != torch.int32:
            raise TypeError(f"verify_windows: {name} must be int32 (u32 "
                            f"bit patterns), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"verify_windows: {name} must be contiguous")
        if t.device != pseq.device:
            raise ValueError(f"verify_windows: {name} is on {t.device}, "
                             f"pseq on {pseq.device}")
    if pseq.dim() != 1 or pseq.numel() == 0:
        raise ValueError("verify_windows: pseq must be a non-empty 1-D tensor")
    if gpos.dim() != 1:
        raise ValueError("verify_windows: gpos must be 1-D (M,)")
    M = gpos.shape[0]
    for name, t in (("conv", conv), ("lane", lane)):
        if tuple(t.shape) != (M, W):
            raise ValueError(f"verify_windows: {name} has shape "
                             f"{tuple(t.shape)}, expected {(M, W)}")


def verify_windows(pseq, gpos, conv, lane, W: int):
    """Fused gather + verify over a worklist of genome positions.

    pseq: (Wg,) int32 packed genome words (u32 bits); gpos: (M,) int32
    window start positions (u32 bits); conv/lane: (M, W) int32 converted
    read words / read-length lane masks.  All contiguous, on one device.
    Returns (mm (M,) int32, win (M, W) int32 u32 bits).
    """
    _check(pseq, gpos, conv, lane, W)
    device = pseq.device
    if device.type == "cpu":
        return verify_windows_reference(pseq, gpos, conv, lane, W)
    if device.type != "cuda":
        raise ValueError(f"verify_windows: unsupported device {device}")
    from walt_tpu_torch import kernels

    lib = kernels.library()
    M = gpos.shape[0]
    mm = torch.empty(M, dtype=torch.int32, device=device)
    win = torch.empty((M, W), dtype=torch.int32, device=device)
    if M == 0:
        return mm, win
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.waltx_verify(
        pseq.data_ptr(), pseq.numel(), gpos.data_ptr(), conv.data_ptr(),
        lane.data_ptr(), M, W, mm.data_ptr(), win.data_ptr(), device.index,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"verify kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return mm, win
