"""Candidate verify over a worklist: the K1 kernel and the fused stage.

Port of ``walt_tpu/ops/pallas_verify.py`` and of the verify stage of
``walt_tpu/ops/pipeline.py`` (``map_strand_core``).  For each worklist row
m, gather the W+1 packed genome words starting at word ``gpos[m] >> 4``,
funnel-shift them into the aligned window ``win[m]`` (W words), and count
the mismatching 2-bit lanes against the converted read words under the
read-length lane mask:

    d = win ^ conv;  mm = sum_j popcount((d | d >> 1) & lane)

Two kernels, each beside its plain PyTorch version:

- :func:`verify_windows` (``csrc/verify.cu``, the port of the Pallas kernel
  K1) takes gathered rows and returns the window; plain version
  :func:`verify_windows_reference`.  It is off the main path.
- :func:`verify_worklist` (``csrc/verify_stage.cu``) is the whole verify
  stage of a strand pass in one launch: from the worklist's (read, seed,
  entry index, valid) rows and the per-read converted words it computes
  the window start, the mismatch count after the pattern's verify_skip
  corrections, and the keep mask (chromosome bounds, ``mm <= max_mm`` and
  the window cared check), with the window kept in registers.  Plain
  version :func:`verify_worklist_reference`, the port's earlier torch ops
  around :func:`verify_windows`.

Each wrapper launches its CUDA kernel on CUDA tensors, and takes the plain
version only for tensors on the CPU.  It never falls back from the kernel
to the plain version: a failed build or launch raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

from walt_tpu_torch.ops import packing
from walt_tpu_torch.ops.packing import MASK32, u32

#: kernel launches made by :func:`verify_windows` (reset by callers that
#: want to show a run went through the kernel)
launches = 0
#: kernel launches made by :func:`verify_worklist`
stage_launches = 0
_count_lock = threading.Lock()
#: per thread: the launches counted while :func:`launch_tally` is open
_tally = threading.local()

#: limits of the fused stage's parameter block (csrc/verify_stage_row.h)
STAGE_MAX_SEEDS, STAGE_MAX_SKIPS, STAGE_MAX_CWT, STAGE_MAX_W = 8, 8, 16, 64


def count_launch(name: str, n: int = 1) -> None:
    """Add ``n`` to the launch counter ``name`` (``"launches"`` or
    ``"stage_launches"``) under a lock: a mesh's dp rows launch from
    several threads, and ``+=`` on a module global is no atomic step.
    Inside :func:`launch_tally` the launches go to the calling thread's
    tally instead."""
    counts = getattr(_tally, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + n
        return
    with _count_lock:
        globals()[name] += n


@contextlib.contextmanager
def launch_tally():
    """Count the calling thread's launches into the dict this yields
    ({counter name: launches}) and not into the module's counters: a step
    captured into a CUDA graph (``ops/graphs``) counts its launches once
    per replay, and its warm-up run and its capture not at all."""
    outer = getattr(_tally, "counts", None)
    _tally.counts = counts = {}
    try:
        yield counts
    finally:
        _tally.counts = outer


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
    count_launch("launches")
    return mm, win


def verify_worklist_reference(wl_read, wl_seedi, wl_entryidx, wl_valid, conv,
                              lens, repeats, index, pseq, start_index, *,
                              seeds, verify_skip, cared_mask, cared_off,
                              max_mm: int, plen: int, cwt: int, n_cared: int,
                              windows=None):
    """Plain PyTorch verify stage, same arguments and results as
    :func:`verify_worklist`; runs on any device.  ``windows``: the window
    step, :func:`verify_windows` unless given (the port's earlier chain
    launches K1 there on a card; :func:`verify_windows_reference` makes the
    whole stage plain torch)."""
    windows = verify_windows if windows is None else windows
    W = conv.shape[1]
    Lmax = W * 16
    shifts_t, cared_off_t, cared_mask_t = _reference_consts(
        conv.device, tuple(int(x) for x in seeds),
        tuple(int(x) for x in np.asarray(cared_off).tolist()),
        None if cared_mask is None else
        np.ascontiguousarray(cared_mask, dtype=np.int64).tobytes(), W)

    wl_shift = shifts_t[wl_seedi]  # (M,)
    # genome POSITIONS are u32 end to end (4 Gbp format); the u32 wraps of
    # the JAX code are reproduced by masking
    wl_entry = u32(index[wl_entryidx.clamp(0, index.shape[0] - 1)])
    si = u32(start_index)
    chrom = torch.searchsorted(si, wl_entry, right=True) - 1
    ch_start = si[chrom]
    ch_end = si[torch.clamp(chrom + 1, max=si.shape[0] - 1)]
    ok_head = ((wl_entry - ch_start) & MASK32) >= wl_shift  # mapping.cpp:282
    wl_gpos = (wl_entry - wl_shift) & MASK32  # wraps only on ~ok_head rows
    wl_len = lens[wl_read]
    ok_tail = ((wl_gpos + wl_len) & MASK32) < ch_end  # mapping.cpp:285

    # converted read words + length lane masks for the worklist rows
    wl_conv = conv[wl_read]  # (M, W)
    wl_lane = packing.len_lane_masks(wl_len, W)
    mm, win = windows(
        pseq, packing.to_i32(wl_gpos), packing.to_i32(wl_conv),
        packing.to_i32(wl_lane), W,
    )
    mm = mm.to(torch.int64)
    win = u32(win)

    wl_rep = repeats[wl_read]
    for shift, min_rep, posn in verify_skip:
        if posn < Lmax:
            wv = (win[:, posn // 16] >> (30 - 2 * (posn % 16))) & 3
            rv = packing.extract_lane(wl_conv, posn)
            cond = ((wl_shift == shift) & (wl_rep >= min_rep)
                    & (posn < wl_len) & (wv != rv))
            mm = mm - cond.to(torch.int64)

    wl_keep = wl_valid & ok_head & ok_tail & (mm <= max_mm)

    if cared_mask is not None:
        # the window cared check: AND the XOR-fold with the per-shift
        # cared-lane mask and a per-row cutoff at cared[seed_len]
        d2 = win ^ wl_conv
        fold2 = (d2 | (d2 >> 1)) & wl_lane
        # cared[j] is periodic-affine: (j // cw) * plen + cared[j % cw]
        slj = torch.clamp(wl_rep * cwt, max=n_cared)  # seed_len per row
        offv = cared_off_t[slj % cwt]
        cutoff = (slj // cwt) * plen + offv + wl_shift
        cut_mask = packing.len_lane_masks(cutoff, W)  # lanes < cutoff
        viol = (fold2 & cared_mask_t[wl_seedi] & cut_mask).any(1)
        wl_keep = wl_keep & ~viol
    return wl_gpos, mm, wl_keep


@functools.lru_cache(maxsize=64)
def _reference_consts(device, seeds, cared_off, cared_mask, W: int):
    """The plain stage's constants as int64 tensors on ``device``, made
    once per set of constants (hashable arguments; ``cared_mask``: the
    (S, W) int64 array's bytes or None): ``seeds``, ``cared_off`` and the
    cared mask (None when the check does not run)."""
    mask = (None if cared_mask is None else torch.from_numpy(
        np.frombuffer(cared_mask, np.int64).reshape(-1, W).copy()).to(device))
    return (torch.tensor(seeds, dtype=torch.int64, device=device),
            torch.tensor(cared_off, dtype=torch.int64, device=device), mask)


class StageArgs(ctypes.Structure):
    """ctypes mirror of ``waltx::StageArgs`` (csrc/verify_stage_row.h)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "wl_read", "wl_seedi", "wl_entryidx", "wl_valid", "conv", "lens",
            "repeats", "index", "pseq", "start_index", "gpos", "mm", "keep")]
        + [(n, ctypes.c_int64) for n in ("M", "B", "n_index", "n_pseq")]
        + [(n, ctypes.c_int32) for n in (
            "n_si", "W", "S", "n_skip", "max_mm", "plen", "cwt", "n_cared",
            "check", "conv_smem_bytes", "si_smem", "pad0")]
        + [("shifts", ctypes.c_int32 * STAGE_MAX_SEEDS),
           ("skip_shift", ctypes.c_int32 * STAGE_MAX_SKIPS),
           ("skip_min_rep", ctypes.c_int32 * STAGE_MAX_SKIPS),
           ("skip_posn", ctypes.c_int32 * STAGE_MAX_SKIPS),
           ("cared_off", ctypes.c_int32 * STAGE_MAX_CWT),
           ("cared_mask", ctypes.c_uint32 * (STAGE_MAX_SEEDS * STAGE_MAX_W))]
    )


def _check_stage(rows, tables, conv, lens, repeats, seeds, skips, cared_mask,
                 cwt) -> None:
    where = "verify_worklist"
    M = rows[0].shape[0]
    for name, t, dtype in (("wl_read", rows[0], torch.int64),
                           ("wl_seedi", rows[1], torch.int64),
                           ("wl_entryidx", rows[2], torch.int64),
                           ("wl_valid", rows[3], torch.bool)):
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != M:
            raise ValueError(f"{where}: {name} must be ({M},) {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if conv.dtype != torch.int64 or conv.dim() != 2:
        raise ValueError(f"{where}: conv must be (B, W) int64 u32 values")
    B, W = conv.shape
    for name, t in (("lens", lens), ("repeats", repeats)):
        if t.dtype != torch.int64 or tuple(t.shape) != (B,):
            raise ValueError(f"{where}: {name} must be ({B},) int64")
    for name, t in tables:
        if t.dtype != torch.int32 or t.dim() != 1 or t.numel() == 0:
            raise ValueError(f"{where}: {name} must be a non-empty 1-D int32 "
                             f"tensor (u32 bits)")
    for name, t in (*zip(("wl_read", "wl_seedi", "wl_entryidx", "wl_valid"),
                         rows), ("conv", conv), ("lens", lens),
                    ("repeats", repeats), *tables):
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous")
        if t.device != conv.device:
            raise ValueError(f"{where}: {name} is on {t.device}, conv on "
                             f"{conv.device}")
    if not (1 <= W <= STAGE_MAX_W and B >= 1):
        raise ValueError(f"{where}: conv has shape {(B, W)}; W must be in "
                         f"[1, {STAGE_MAX_W}]")
    if not (1 <= len(seeds) <= STAGE_MAX_SEEDS) or len(skips) > \
            STAGE_MAX_SKIPS or not (1 <= cwt <= STAGE_MAX_CWT):
        raise ValueError(f"{where}: {len(seeds)} seeds, {len(skips)} "
                         f"verify_skip triples or cared_weight {cwt} out of "
                         f"range")
    if cared_mask is not None and np.shape(cared_mask) != (len(seeds), W):
        raise ValueError(f"{where}: cared_mask must be {(len(seeds), W)}")


def verify_worklist(wl_read, wl_seedi, wl_entryidx, wl_valid, conv, lens,
                    repeats, index, pseq, start_index, *, seeds, verify_skip,
                    cared_mask, cared_off, max_mm: int, plen: int, cwt: int,
                    n_cared: int):
    """The verify stage of one strand pass, fused (``csrc/verify_stage.cu``).

    Rows (M,): ``wl_read``, ``wl_seedi``, ``wl_entryidx`` int64 and
    ``wl_valid`` bool; per read (B,): ``conv`` (B, W) int64 converted read
    words (u32 values), ``lens`` and ``repeats`` int64; tables (int32, u32
    bits): ``index``, ``pseq``, ``start_index``.  Small constants:
    ``seeds`` (the shift of each seed index), ``verify_skip`` (the pattern's
    (shift, min_rep, posn) triples), ``cared_mask`` ((S, W) lane masks of
    the cared positions the window cared check enforces, or None when the
    check does not run), ``cared_off`` (cared[:cwt]), ``max_mm``, ``plen``,
    ``cwt`` (cared_weight) and ``n_cared``.

    Returns (wl_gpos (M,) int64 u32 values, mm (M,) int64, wl_keep (M,)
    bool).
    """
    rows = (wl_read, wl_seedi, wl_entryidx, wl_valid)
    tables = (("index", index), ("pseq", pseq), ("start_index", start_index))
    _check_stage(rows, tables, conv, lens, repeats, seeds,
                 _skips(verify_skip, conv.shape[-1]), cared_mask, cwt)
    kw = dict(seeds=seeds, verify_skip=verify_skip, cared_mask=cared_mask,
              cared_off=cared_off, max_mm=max_mm, plen=plen, cwt=cwt,
              n_cared=n_cared)
    device = conv.device
    if device.type == "cpu":
        return verify_worklist_reference(*rows, conv, lens, repeats, index,
                                         pseq, start_index, **kw)
    if device.type != "cuda":
        raise ValueError(f"verify_worklist: unsupported device {device}")
    from walt_tpu_torch import kernels

    lib = kernels.library()
    M = wl_read.shape[0]
    gpos = torch.empty(M, dtype=torch.int64, device=device)
    mm = torch.empty(M, dtype=torch.int64, device=device)
    keep = torch.empty(M, dtype=torch.bool, device=device)
    if M == 0:
        return gpos, mm, keep
    a = stage_args((*rows, conv, lens, repeats, index, pseq, start_index),
                   (gpos, mm, keep), **kw)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.waltx_verify_stage(ctypes.byref(a), device.index, stream)
    if err != 0:
        raise RuntimeError(f"verify stage kernel launch failed: CUDA error "
                           f"{err}")
    count_launch("stage_launches")
    return gpos, mm, keep


def _skips(verify_skip, W: int) -> tuple:
    """The verify_skip triples whose position lies in a W-word window."""
    return tuple(tuple(int(x) for x in t) for t in verify_skip
                 if t[2] < 16 * W)


def stage_args(inputs, outs, *, seeds, verify_skip, cared_mask, cared_off,
               max_mm, plen, cwt, n_cared) -> StageArgs:
    """The kernel's parameter block for the ten input tensors of
    :func:`verify_worklist` (in its order) and its three outputs; pointers
    by ``data_ptr``, so the caller keeps the tensors alive over the launch.
    The constant part is built once per set of constants."""
    conv = inputs[4]
    cm = (None if cared_mask is None
          else np.ascontiguousarray(cared_mask, dtype=np.int64).tobytes())
    a = StageArgs.from_buffer_copy(_stage_consts(
        conv.shape[1], tuple(int(x) for x in seeds),
        _skips(verify_skip, conv.shape[1]), cm,
        tuple(int(x) for x in np.asarray(cared_off).tolist()), int(max_mm),
        int(plen), int(cwt), int(n_cared)))
    for (name, _), t in zip(StageArgs._fields_[:13], (*inputs, *outs)):
        setattr(a, name, t.data_ptr())
    a.M, a.B = inputs[0].shape[0], conv.shape[0]
    a.n_index, a.n_pseq = inputs[7].shape[0], inputs[8].shape[0]
    a.n_si = inputs[9].shape[0]
    return a


@functools.lru_cache(maxsize=64)
def _stage_consts(W, seeds, skips, cared_mask, cared_off, max_mm, plen, cwt,
                  n_cared) -> bytes:
    """The constant fields of a :class:`StageArgs`, as bytes (hashable
    arguments; ``cared_mask``: the int64 (S, W) array's bytes or None)."""
    a = StageArgs()
    a.W, a.S, a.n_skip = W, len(seeds), len(skips)
    a.max_mm, a.plen, a.cwt, a.n_cared = max_mm, plen, cwt, n_cared
    a.check = cared_mask is not None
    for i, s in enumerate(seeds):
        a.shifts[i] = s
    for i, (shift, min_rep, posn) in enumerate(skips):
        a.skip_shift[i], a.skip_min_rep[i], a.skip_posn[i] = shift, min_rep, posn
    for i, c in enumerate(cared_off):
        a.cared_off[i] = c
    if cared_mask is not None:
        for i, v in enumerate(np.frombuffer(cared_mask, np.int64).tolist()):
            a.cared_mask[i] = v
    return bytes(a)
