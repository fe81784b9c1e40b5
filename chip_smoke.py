#!/usr/bin/env python3
"""Smoke test of walt_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels (csrc/) with nvcc into build/kernels/;
3. kernel vs plain: every kernel against its plain PyTorch version on the
   card, exact equality, at the main-path shape and at edge shapes; times
   both at the main-path shape, as device time (torch.profiler) and as
   wall time per wrapper call (CUDA events);
4. data: a 128 Mbp repetitive synthetic genome (about the size of the
   Arabidopsis thaliana genome, a standard WGBS organism), its WALT index
   and 1,000,000 x 100 bp bisulfite reads, built once into
   build/smoke_data/;
5. backend parity: TorchBackend.map_single_end on all reads == the native
   exact replay on every read the device resolved, with a device-resolved
   share of at least 75%;
6. end to end: the port's CLI (one warm-up run, one timed run) writes MR
   output and .mapstats byte-identical to the exact host path.

The last two lines are one JSON object describing the kernels (``ms`` and
``plain_ms`` are device time per call, ``wall_ms`` and ``plain_wall_ms``
wall time per call) and one JSON object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "build", "smoke_data")
GENOME_BASES = 128_000_000
N_READS = 1_000_000
READ_LEN = 100
#: share of reads the device must resolve without the host fallback
MIN_DEVICE_SHARE = 0.75
#: main-path worklist shape of the verify kernel: tier-1 worklist factor 1.5
#: x the 131,072-read chunk, 7 words for 100 bp reads
MAIN_M, MAIN_W = 196_608, 7


def say(phase: str, msg: str) -> None:
    print(f"[chip_smoke] {phase}: {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call of ``fn`` between CUDA events around
    ``reps`` back-to-back calls.  For a short kernel this is wall time per
    wrapper call: host launch overhead, not the kernel's device time."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: the summed durations of
    the device events torch.profiler records over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        raise RuntimeError("torch.profiler recorded no device events")
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / reps


def verify_inputs(rng, M: int, W: int, Wg: int, device):
    """Verify-kernel inputs that cover every in-word shift (sh = 0..30),
    windows clamped at the genome end and wrapped u32 starts >= 2^31."""
    import numpy as np
    import torch

    from walt_tpu_torch.ops import packing

    pseq = rng.integers(0, 1 << 32, Wg, dtype=np.uint32)
    gpos = rng.integers(0, Wg * 16, M).astype(np.uint32)
    gpos = (gpos & ~np.uint32(15)) | (np.arange(M) % 16).astype(np.uint32)
    gpos[:16] = (Wg - 1) * 16 + np.arange(16)  # needs M >= 19
    gpos[16:19] = [0x80000000, 0x9000000F, 0xFFFFFFF1]
    conv = rng.integers(0, 1 << 32, (M, W), dtype=np.uint32)
    lens = torch.from_numpy(rng.integers(0, W * 16 + 1, M))
    lane = packing.len_lane_masks(lens, W).numpy().astype(np.uint32)
    return [packing.from_np(a, device) for a in (pseq, gpos, conv, lane)]


def check_verify_kernel(device, Wg: int):
    """Phase 3: kernel == plain on every listed shape; times at the main
    shape.  Returns (max_abs_err, kernel device ms, plain device ms,
    kernel wall ms per call, plain wall ms per call)."""
    import numpy as np
    import torch

    from walt_tpu_torch.ops import packing, verify

    rng = np.random.default_rng(2024)
    shapes = [(MAIN_M, MAIN_W), (1001, 7), (257, 7), (5003, 1), (5003, 3),
              (5003, 13), (5003, 63)]
    err = 0
    for M, W in shapes:
        args = verify_inputs(rng, M, W, Wg, device)
        mm_k, win_k = verify.verify_windows(*args, W)
        mm_r, win_r = verify.verify_windows_reference(*args, W)
        torch.cuda.synchronize()
        d_mm = int((mm_k.long() - mm_r.long()).abs().max())
        d_win = int((packing.u32(win_k) - packing.u32(win_r)).abs().max())
        err = max(err, d_mm, d_win)
        if d_mm or d_win:
            raise AssertionError(f"verify kernel != plain at M={M} W={W}: "
                                 f"max |d mm| {d_mm}, max |d win| {d_win}")
    args = verify_inputs(rng, MAIN_M, MAIN_W, Wg, device)
    kern = lambda: verify.verify_windows(*args, MAIN_W)  # noqa: E731
    plain = lambda: verify.verify_windows_reference(*args, MAIN_W)  # noqa: E731
    # in turns: plain, kernel, kernel, plain
    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kern, kern, plain))
    dp1, dk1, dk2, dp2 = (device_ms(f) for f in (plain, kern, kern, plain))
    say("kernel", f"verify_windows == plain on {len(shapes)} shapes "
                  f"(sh 0..30, end clamp, gpos >= 2^31); at M={MAIN_M} "
                  f"W={MAIN_W}: device time (torch.profiler) kernel "
                  f"{dk1 * 1e3:.1f}/{dk2 * 1e3:.1f} us, plain "
                  f"{dp1 * 1e3:.1f}/{dp2 * 1e3:.1f} us per call; wall per "
                  f"call (CUDA events over 50 calls, launch-bound) kernel "
                  f"{k1 * 1e3:.1f}/{k2 * 1e3:.1f} us, plain "
                  f"{p1 * 1e3:.1f}/{p2 * 1e3:.1f} us")
    return (err, (dk1 + dk2) / 2, (dp1 + dp2) / 2, (k1 + k2) / 2,
            (p1 + p2) / 2)


def build_data(data_dir: str, n_bases: int, n_reads: int, read_len: int):
    """Phase 4: genome FASTA, 5-file WALT index and FASTQ, built once."""
    from walt_tpu.index.build import build_all_tables
    from walt_tpu.index.io_walt import write_index
    from walt_tpu.synth import (
        codes_to_fastq, make_genome_repetitive, sample_reads,
        write_genome_fasta,
    )

    index = os.path.join(data_dir, "smoke.dbindex")
    fastq = os.path.join(data_dir, "reads.fq")
    stamp = os.path.join(data_dir, f"{n_bases}_{n_reads}_{read_len}.ok")
    if os.path.exists(stamp):
        say("data", f"cached in {data_dir}")
        return index, fastq
    os.makedirs(data_dir, exist_ok=True)
    t0 = time.perf_counter()
    genome = make_genome_repetitive(n_bases, n_chroms=2, seed=42)
    fasta = os.path.join(data_dir, "genome.fa")
    write_genome_fasta(genome, fasta)
    codes, lens, _ = sample_reads(genome, n_reads, read_len, seed=7)
    codes_to_fastq(codes, lens, fastq)
    del genome, codes
    t1 = time.perf_counter()
    g, tables = build_all_tables([fasta], verbose=False)
    write_index(index, g, tables)
    t2 = time.perf_counter()
    open(stamp, "w").close()
    say("data", f"{n_bases / 1e6:.0f} Mbp genome + {n_reads} x {read_len} bp "
                f"reads in {t1 - t0:.1f} s, 4-table index in {t2 - t1:.1f} s")
    return index, fastq


def backend_parity(index: str, fastq: str, device, min_share: float):
    """Phase 5: TorchBackend.map_single_end == native.se_exact on every
    device-resolved read."""
    import numpy as np
    import torch

    from walt_tpu import native
    from walt_tpu.constants import get_pattern
    from walt_tpu.host.fastq import FgetsLines, load_batch
    from walt_tpu.index import io_walt
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.ops import verify

    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(index)
    tables = [io_walt.read_table_cached(index + s, gm)
              for s in ("_CT00", "_CT01")]
    lines = FgetsLines(fastq)
    codes, lens = load_batch(lines, 1 << 40).packed()
    lines.close()
    n = codes.shape[0]
    backend = TorchBackend(device=device)
    backend.table_budget_hint = 2
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    verify.launches = 0
    t0 = time.perf_counter()
    pos, times, minus, mm, fb = backend.map_single_end(
        codes, lens, tables, 5000, 6, pattern)
    t1 = time.perf_counter()
    launches = verify.launches
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ref = native.se_exact(codes, lens, tables, False, 5000, 6, pattern)
    t2 = time.perf_counter()
    if ref is None:
        raise RuntimeError("the native exact replay library is unavailable")
    ok = ~fb
    for name, got, want in zip(("pos", "times", "minus", "mm"),
                               (pos, times, minus, mm), ref):
        bad = np.flatnonzero(got[ok] != want[ok])
        if bad.size:
            raise AssertionError(f"device {name} != native exact replay on "
                                 f"{bad.size} resolved reads")
    share = float(ok.mean())
    if backend.total_reads != n:
        raise AssertionError(f"total_reads {backend.total_reads} != {n}")
    if launches <= 0:
        raise AssertionError("the mapping never launched the verify kernel")
    if share < min_share:
        raise AssertionError(f"device-resolved share {share:.4f} < "
                             f"{min_share}")
    say("parity", f"{n} reads: device-resolved share {share:.4f}, equal to "
                  f"native.se_exact on all of them; rung {backend.rungs}; "
                  f"verify launches {launches}; map_single_end "
                  f"{t1 - t0:.2f} s (tables included), se_exact on all "
                  f"reads {t2 - t1:.2f} s; peak device memory "
                  f"{peak / 2**30:.2f} GiB")
    backend.free_tables()
    return share, peak


class AllFallback:
    """A backend whose device step resolves nothing: process_single_end maps
    every read on the exact host path (native.se_exact)."""

    def map_single_end(self, codes, lens, tables, b, max_mismatches, pattern,
                       ag_wildcard=False):
        import numpy as np

        n = codes.shape[0]
        return (np.zeros(n, np.uint32), np.zeros(n, np.int32),
                np.zeros(n, bool), np.full(n, max_mismatches, np.int32),
                lens >= pattern.min_read_len)


def end_to_end(index: str, fastq: str, device, n_reads: int):
    """Phase 6: the CLI's output == the exact host path's, byte for byte.
    Returns (launches of the timed run, wall seconds)."""
    from walt_tpu import perf
    from walt_tpu.core.single_end import process_single_end
    from walt_tpu_torch import cli
    from walt_tpu_torch.ops import verify

    work = os.path.dirname(index)
    out = os.path.join(work, "torch.mr")
    argv = ["-i", index, "-r", fastq, "-o", out, "--device", device.type]
    if cli.main(argv) != 0:  # warm-up: kernel load, first allocations
        raise AssertionError("the CLI warm-up run failed")
    perf.reset()
    verify.launches = 0
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("the timed CLI run failed")
    wall = time.perf_counter() - t0
    launches = verify.launches
    stages = perf.snapshot()

    ref = os.path.join(work, "exact.mr")
    open(ref, "w").close()
    open(ref + ".mapstats", "w").close()
    process_single_end(index, fastq, ref, backend=AllFallback())
    for suffix in ("", ".mapstats"):
        with open(out + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"CLI output{suffix or ' (MR)'} differs "
                                     f"from the exact host path")
    if launches <= 0:
        raise AssertionError("the CLI run never launched the verify kernel")
    say("e2e", f"CLI {n_reads / wall:.1f} reads/s ({wall:.2f} s wall for "
               f"{n_reads} reads, tables included), verify launches "
               f"{launches}; MR and .mapstats byte-identical to the exact "
               f"host path; host stages {stages}")
    return launches, wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from walt_tpu_torch import kernels  # fails outside a repo checkout

    device = torch.device("cuda", 0)
    card = card_line()
    say("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    print(card, flush=True)

    t0 = time.perf_counter()
    log = kernels.build()
    kernels.library()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    say("build", f"nvcc {time.perf_counter() - t0:.1f} s "
                 f"{'(up to date)' if not log else ''}{'; '.join(ptxas)}")

    # a genome-sized pseq: 128 Mbp -> 8M packed words
    err, k_ms, p_ms, k_wall, p_wall = check_verify_kernel(
        device, Wg=GENOME_BASES // 16)
    index, fastq = build_data(DATA, GENOME_BASES, N_READS, READ_LEN)
    backend_parity(index, fastq, device, MIN_DEVICE_SHARE)
    launches, _ = end_to_end(index, fastq, device, N_READS)

    if "jax" in sys.modules:
        raise AssertionError("walt_tpu_torch imported jax")
    print(json.dumps({"kernels": [{
        "name": "verify_windows", "route": "cuda",
        "source": "walt_tpu_torch/csrc/verify.cu",
        "replaces": "walt_tpu/ops/pallas_verify.py:93",
        "launches": launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms,
        "wall_ms": k_wall, "plain_wall_ms": p_wall,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
