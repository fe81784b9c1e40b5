"""The H100's peaks and the fused verify stage's least bytes and
operations: the arithmetic a roofline share of ``verify_stage_kernel``
needs, frozen here from the port's smoke test so that the yardstick does
not move with the program.

No metric reads it yet: the real passes' worklists (their rows, distinct
index entries and genome words) live inside the CUDA graph replays, so a
share needs the program to count them per pass (PERF.md, Open questions).
"""

from __future__ import annotations

#: NVIDIA's published H100 SXM peaks at 700 W: HBM3 bytes per second, and
#: int32 operations per second (64 INT32 lanes per SM, half the 67 TFLOP/s
#: float32 rate outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 33.5e12


def bound(n_bytes: float, n_ops: float):
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the integer operations over the int32
    rate."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def windows_bound(args, W: int):
    """``verify_windows`` (K1) on these inputs: gpos, conv and lane read
    once, the distinct genome words the windows touch, mm and win written
    once; about 7 integer operations per word."""
    import torch

    pseq, gpos, conv, lane = args
    M = gpos.shape[0]
    words = ((gpos.long() & 0xFFFFFFFF) >> 4)[:, None] + torch.arange(
        W + 1, device=gpos.device)
    n_words = torch.unique(words.clamp_(max=pseq.shape[0] - 1)).numel()
    n_bytes = 4 * M + 8 * M * W + 4 * n_words + 4 * M + 4 * M * W
    return bound(n_bytes, M * (7 * W + 5))


def stage_bound(args, kw):
    """``verify_worklist`` (the fused stage) on these inputs, counted once:
    each row's three int64 indices and valid flag, the distinct index
    entries and genome words the rows touch, the conv words, length and
    repeat count of each distinct read, start_index, and gpos, mm (int64)
    and keep written; about 14 integer operations per word and 60 per
    row."""
    import torch

    (wl_read, wl_seedi, wl_entryidx, _, conv, _, _, index, pseq,
     start_index) = args
    M = wl_read.shape[0]
    W = conv.shape[1]
    e = wl_entryidx.clamp(0, index.shape[0] - 1)
    shifts = torch.as_tensor(kw["seeds"], device=e.device)[wl_seedi]
    gpos = ((index[e].long() & 0xFFFFFFFF) - shifts) & 0xFFFFFFFF
    words = (gpos >> 4)[:, None] + torch.arange(W + 1, device=e.device)
    n_words = torch.unique(words.clamp_(max=pseq.shape[0] - 1)).numel()
    n_entries = torch.unique(e).numel()
    n_reads = torch.unique(wl_read).numel()
    n_bytes = (25 * M + 4 * n_entries + 4 * n_words
               + n_reads * (8 * W + 16) + 4 * start_index.shape[0] + 17 * M)
    return bound(n_bytes, M * (14 * W + 60))
