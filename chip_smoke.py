#!/usr/bin/env python3
"""Smoke test of walt_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels (csrc/) with nvcc into build/kernels/;
3. kernel vs plain: every kernel against its plain PyTorch version on the
   card, exact equality, at the SE and PE main-path shapes and at edge
   shapes; times both at the SE main-path shape, as device time
   (torch.profiler) and as wall time per wrapper call (CUDA events);
4. data: a 128 Mbp repetitive synthetic genome (about the size of the
   Arabidopsis thaliana genome, a standard WGBS organism), its WALT index,
   1,000,000 x 100 bp bisulfite reads and 500,000 x 100 bp bisulfite read
   pairs (fragments 150-500 bp), built once into build/smoke_data/;
5. SE backend parity: TorchBackend.map_single_end on all reads == the
   native exact replay on every read the device resolved, with a
   device-resolved share of at least 75%;
6. SE end to end: the port's CLI (one warm-up run, one timed run) writes MR
   output and .mapstats byte-identical to the exact host path;
7. PE backend parity: TorchBackend.map_mate_slabs on both mates, finalized
   by native.pe_finalize, == the native exact ranking and pair join on
   every pair the device resolved, with a device-resolved share of at
   least 75%;
8. PE end to end: the port's CLI with -1/-2 (one warm-up run, one timed
   run) writes MR output and .mapstats byte-identical to the exact host
   path.

Phases 9-12 run the multi-device path on a (dp, tp) mesh, every table
split tp=2 by bucket range: over all cards when there are two or more,
else a virtual dp=2 x tp=2 mesh over the one card (four shards' worth of
work on one card: it shows correctness and overhead, not scaling).  They
use the first 250,000 reads and 125,000 pairs of phase 4's data:

9. mesh SE parity: TorchBackend(mesh).map_single_end == native.se_exact on
   every read it resolved, with a device-resolved share of at least 75%,
   and == the single-device backend wherever neither side fell back; both
   timed on the same reads (first call with table setup, then steady calls
   in turns), and one more steady mesh call timed pass by pass (phase A,
   phase B, each slab tier);
10. mesh PE parity: the same for map_mate_slabs, finalized by
    native.pe_finalize against the exact ranking and pair join, with a
    pair share of at least 65% (see MIN_MESH_PE_SHARE);
11. mesh end to end: process_single_end and process_paired_end on the mesh
    backend write MR and .mapstats byte-identical to the exact host path
    (with two or more cards, the CLI's --tp 2 as well);
12. entry.dryrun_multichip(4): the dry run on four devices (the first card
    four times when there are fewer).

The last two lines are one JSON object describing the kernels (``ms`` and
``plain_ms`` are device time per call, ``wall_ms`` and ``plain_wall_ms``
wall time per call; ``launches`` and ``launches_pe`` count the launches of
the timed SE and PE CLI runs, ``launches_mesh`` and ``launches_mesh_pe``
those of phase 11's SE and PE runs) and one JSON object
``{"ok": true, "device": {...}}``.
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
N_PAIRS = 500_000
READ_LEN = 100
#: share of reads the device must resolve without the host fallback
MIN_DEVICE_SHARE = 0.75
#: main-path worklist shape of the verify kernel: tier-1 worklist factor 1.5
#: x the 131,072-read chunk, 7 words for 100 bp reads
MAIN_M, MAIN_W = 196_608, 7
#: the PE mate step's verify shape: worklist factor 3 x the 131,072-read
#: chunk
PE_M = 393_216
#: reads and pairs of the mesh phases 9-11 (the first of phase 4's)
N_MESH_READS = 250_000
N_MESH_PAIRS = 125_000
#: pair share the tp=2 mesh must resolve on the device.  Lower than
#: MIN_DEVICE_SHARE: a converted read has three bases, so one of two
#: bucket-range shards owns about 2/3 of its (read, seed) pairs, while the
#: routed row capacity (walt_tpu's int(1.25 * pairs / T) + 128, kept so the
#: port equals walt_tpu exactly) holds 5/8; the reads past it fall back, and
#: the PE step has no device tiers to take them (0.6849 measured on an H100)
MIN_MESH_PE_SHARE = 0.65


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
    """Phase 3: kernel == plain on every listed shape; times at the SE
    main shape (and device time at the PE one).  Returns (max_abs_err,
    kernel device ms, plain device ms, kernel wall ms per call, plain wall
    ms per call), all at the SE main shape."""
    import numpy as np
    import torch

    from walt_tpu_torch.ops import packing, verify

    rng = np.random.default_rng(2024)
    shapes = [(MAIN_M, MAIN_W), (PE_M, MAIN_W), (1001, 7), (257, 7),
              (5003, 1), (5003, 3), (5003, 13), (5003, 63)]
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
    pe_args = verify_inputs(rng, PE_M, MAIN_W, Wg, device)
    pe_k, pe_p = (device_ms(lambda f=f: f(*pe_args, MAIN_W))
                  for f in (verify.verify_windows,
                            verify.verify_windows_reference))
    say("kernel", f"verify_windows == plain on {len(shapes)} shapes "
                  f"(sh 0..30, end clamp, gpos >= 2^31); at M={MAIN_M} "
                  f"W={MAIN_W}: device time (torch.profiler) kernel "
                  f"{dk1 * 1e3:.1f}/{dk2 * 1e3:.1f} us, plain "
                  f"{dp1 * 1e3:.1f}/{dp2 * 1e3:.1f} us per call; wall per "
                  f"call (CUDA events over 50 calls, launch-bound) kernel "
                  f"{k1 * 1e3:.1f}/{k2 * 1e3:.1f} us, plain "
                  f"{p1 * 1e3:.1f}/{p2 * 1e3:.1f} us; at the PE shape "
                  f"M={PE_M}: device time kernel {pe_k * 1e3:.1f} us, plain "
                  f"{pe_p * 1e3:.1f} us per call")
    return (err, (dk1 + dk2) / 2, (dp1 + dp2) / 2, (k1 + k2) / 2,
            (p1 + p2) / 2)


def build_data(data_dir: str, n_bases: int, n_reads: int, n_pairs: int,
               read_len: int):
    """Phase 4: genome FASTA, 5-file WALT index, SE FASTQ and the two PE
    FASTQs, each built once (the SE set and the PE set under stamps of
    their own).  Returns (index, fastq, (fastq_1, fastq_2))."""
    from walt_tpu.index.build import build_all_tables
    from walt_tpu.index.io_walt import write_index
    from walt_tpu.synth import (
        codes_to_fastq, make_genome_repetitive, sample_pairs, sample_reads,
        write_genome_fasta,
    )

    index = os.path.join(data_dir, "smoke.dbindex")
    fastq = os.path.join(data_dir, "reads.fq")
    pe = (os.path.join(data_dir, "pairs_1.fq"),
          os.path.join(data_dir, "pairs_2.fq"))
    stamp = os.path.join(data_dir, f"{n_bases}_{n_reads}_{read_len}.ok")
    pe_stamp = os.path.join(data_dir,
                            f"pe_{n_bases}_{n_pairs}_{read_len}.ok")
    if os.path.exists(stamp) and os.path.exists(pe_stamp):
        say("data", f"cached in {data_dir}")
        return index, fastq, pe
    os.makedirs(data_dir, exist_ok=True)
    t0 = time.perf_counter()
    genome = make_genome_repetitive(n_bases, n_chroms=2, seed=42)
    if not os.path.exists(pe_stamp):
        c1, l1, c2, l2 = sample_pairs(genome, n_pairs, read_len, seed=11,
                                      frag_lo=150, frag_hi=500)
        codes_to_fastq(c1, l1, pe[0])
        codes_to_fastq(c2, l2, pe[1])
        del c1, c2
        open(pe_stamp, "w").close()
    t1 = time.perf_counter()
    say("data", f"{n_pairs} x {read_len} bp read pairs in "
                f"{t1 - t0:.1f} s (genome included)")
    if os.path.exists(stamp):
        return index, fastq, pe
    fasta = os.path.join(data_dir, "genome.fa")
    write_genome_fasta(genome, fasta)
    codes, lens, _ = sample_reads(genome, n_reads, read_len, seed=7)
    codes_to_fastq(codes, lens, fastq)
    del genome, codes
    t2 = time.perf_counter()
    g, tables = build_all_tables([fasta], verbose=False)
    write_index(index, g, tables)
    t3 = time.perf_counter()
    open(stamp, "w").close()
    say("data", f"{n_bases / 1e6:.0f} Mbp genome + {n_reads} x {read_len} bp "
                f"reads in {t2 - t1:.1f} s, 4-table index in {t3 - t2:.1f} s")
    return index, fastq, pe


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


#: the per-pair fields of native.pe_finalize compared with the exact path
PE_FIELDS = ("code", "r1_mm", "r1_pos", "r1_strand", "r2_mm", "r2_pos",
             "r2_strand")
PE_MATE_FIELDS = ("bm_pos", "bm_times", "bm_strand", "bm_mm")


def map_pairs_vs_exact(backend, mates, tables, chrom_start):
    """TorchBackend.map_mate_slabs on both mates (mate 1 C->T on the CT
    tables, mate 2 G->A on the GA tables), finalized by native.pe_finalize
    with the OR of the mates' fallback masks as ``skip``, against
    native.pe_exact_ranked + pe_join_ranked on all pairs, at the CLI's
    default flags.  Raises on any difference in a pair no mate sent to
    fallback.  Returns (resolved share, verify launches, map_mate_slabs
    seconds, exact-path seconds)."""
    import numpy as np

    from walt_tpu import native
    from walt_tpu.constants import get_pattern
    from walt_tpu_torch.ops import verify

    pattern = get_pattern("3")
    top_k, frag_range, b, max_mm = 50, 1000, 5000, 6
    (codes1, lens1), (codes2, lens2) = mates
    lens1, lens2 = lens1.astype(np.int32), lens2.astype(np.int32)
    verify.launches = 0
    t0 = time.perf_counter()
    s1, fb1 = backend.map_mate_slabs(codes1, lens1, tables[0], False, b,
                                     max_mm, pattern)
    s2, fb2 = backend.map_mate_slabs(codes2, lens2, tables[1], True, b,
                                     max_mm, pattern)
    t1 = time.perf_counter()
    launches = verify.launches
    skip = fb1 | fb2
    fin = native.pe_finalize(s1 + s2, skip.astype(np.uint8), lens1, lens2,
                             chrom_start, top_k, frag_range, max_mm,
                             pattern.exit1_seed)
    t2 = time.perf_counter()
    ranked = [native.pe_exact_ranked(c, n, t, ag, b, max_mm, top_k, pattern)
              for c, n, t, ag in ((codes1, lens1, tables[0], False),
                                  (codes2, lens2, tables[1], True))]
    if fin is None or ranked[0] is None:
        raise RuntimeError("the native PE library is unavailable")
    exact = native.pe_join_ranked(ranked[0], ranked[1], lens1, lens2,
                                  chrom_start, frag_range, max_mm, top_k)
    t3 = time.perf_counter()
    ok = ~skip
    for k in PE_FIELDS + PE_MATE_FIELDS:
        got, want = fin[k], exact[k]
        if k in PE_MATE_FIELDS:
            got, want = got.reshape(-1, 2), want.reshape(-1, 2)
        diff = got[ok] != want[ok]
        n_bad = int((diff.any(1) if diff.ndim > 1 else diff).sum())
        if n_bad:
            raise AssertionError(f"finalized {k} != exact path on {n_bad} "
                                 f"resolved pairs")
    if launches <= 0:
        raise AssertionError("the PE mapping never launched the verify "
                             "kernel")
    return float(ok.mean()), launches, t1 - t0, t3 - t2


def pe_parity(index: str, pe, device, min_share: float):
    """Phase 7: TorchBackend.map_mate_slabs + native.pe_finalize == the
    exact PE path on every device-resolved pair."""
    import numpy as np
    import torch

    from walt_tpu.host.fastq import FgetsLines, load_batch
    from walt_tpu.index import io_walt
    from walt_tpu_torch.core.torch_backend import TorchBackend

    gm, _ = io_walt.read_head(index)
    tables = [[io_walt.read_table_cached(index + s, gm) for s in pair]
              for pair in (("_CT00", "_CT01"), ("_GA10", "_GA11"))]
    mates = []
    for fq in pe:
        lines = FgetsLines(fq)
        mates.append(load_batch(lines, 1 << 40).packed())
        lines.close()
    n = mates[0][0].shape[0]
    backend = TorchBackend(device=device)
    backend.table_budget_hint = 4
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    share, launches, t_map, t_exact = map_pairs_vs_exact(
        backend, mates, tables, gm.start_index.astype(np.uint32))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if backend.total_reads != 2 * n:
        raise AssertionError(f"total_reads {backend.total_reads} != {2 * n}")
    if share < min_share:
        raise AssertionError(f"device-resolved pair share {share:.4f} < "
                             f"{min_share}")
    say("pe parity", f"{n} pairs: device-resolved pair share {share:.4f}, "
                     f"finalized pairs equal to the exact path on all of "
                     f"them; rungs {backend.rungs}; verify launches "
                     f"{launches}; map_mate_slabs (both mates) {t_map:.2f} s "
                     f"(tables included), exact ranking + join on all pairs "
                     f"{t_exact:.2f} s; peak device memory "
                     f"{peak / 2**30:.2f} GiB")
    backend.free_tables()
    return share, peak


class AllFallbackPE:
    """A PE backend whose mate step resolves nothing: process_paired_end
    maps every pair on the exact host path (native.pe_exact_ranked +
    pe_join_ranked)."""

    cand_slab = 1

    def map_mate_slabs_begin(self, codes, lens, tables, ag_wildcard, b,
                             max_mismatches, pattern):
        return codes.shape[0]

    def map_mate_slabs_finish(self, n):
        import numpy as np

        return [dict(seed=np.zeros((n, 1), np.int8),
                     pos=np.zeros((n, 1), np.uint32),
                     mm=np.zeros((n, 1), np.int32),
                     cnt=np.zeros(n, np.int32)) for _ in range(2)], \
            np.ones(n, bool)

    def map_mate_slabs(self, *args):
        return self.map_mate_slabs_finish(self.map_mate_slabs_begin(*args))


def pe_end_to_end(index: str, pe, device, n_pairs: int):
    """Phase 8: the CLI's PE output == the exact host path's, byte for
    byte.  Returns (launches of the timed run, wall seconds)."""
    from walt_tpu import perf
    from walt_tpu.core.paired_end import process_paired_end
    from walt_tpu_torch import cli
    from walt_tpu_torch.ops import verify

    work = os.path.dirname(index)
    out = os.path.join(work, "torch_pe.mr")
    argv = ["-i", index, "-1", pe[0], "-2", pe[1], "-o", out,
            "--device", device.type]
    if cli.main(argv) != 0:  # warm-up: kernel load, first allocations
        raise AssertionError("the PE CLI warm-up run failed")
    perf.reset()
    verify.launches = 0
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("the timed PE CLI run failed")
    wall = time.perf_counter() - t0
    launches = verify.launches
    stages = perf.snapshot()

    ref = os.path.join(work, "exact_pe.mr")
    open(ref, "w").close()
    open(ref + ".mapstats", "w").close()
    process_paired_end(index, pe[0], pe[1], ref, backend=AllFallbackPE())
    for suffix in ("", ".mapstats"):
        with open(out + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"PE CLI output{suffix or ' (MR)'} "
                                     f"differs from the exact host path")
    if launches <= 0:
        raise AssertionError("the PE CLI run never launched the verify "
                             "kernel")
    say("pe e2e", f"CLI {n_pairs / wall:.1f} pairs/s ({wall:.2f} s wall for "
                  f"{n_pairs} pairs, tables included), verify launches "
                  f"{launches}; MR and .mapstats byte-identical to the exact "
                  f"host path; host stages {stages}")
    return launches, wall


def smoke_mesh():
    """Phases 9-12's mesh: tp=2 over every card (an even count) when there
    are two or more, else a virtual dp=2 x tp=2 mesh over card 0.  Returns
    (mesh, virtual)."""
    import torch

    from walt_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    if n >= 2:
        return make_mesh([torch.device("cuda", i)
                          for i in range(n - n % 2)], tp=2), False
    return make_mesh([torch.device("cuda", 0)] * 4, tp=2), True


def head_fastq(src: str, dst: str, n_records: int) -> str:
    """The first ``n_records`` FASTQ records of ``src`` in ``dst``, written
    once (through a temporary file, so a cut run leaves no partial one)."""
    if not os.path.exists(dst):
        tmp = dst + ".tmp"
        with open(src) as f, open(tmp, "w") as g:
            for i, line in enumerate(f):
                if i >= 4 * n_records:
                    break
                g.write(line)
        os.replace(tmp, dst)
    return dst


def load_reads(fastq: str, n: int):
    """(codes, lens) of the first ``n`` reads of ``fastq``."""
    from walt_tpu.host.fastq import FgetsLines, load_batch

    lines = FgetsLines(fastq)
    try:
        return load_batch(lines, n).packed()
    finally:
        lines.close()


def timed(fn):
    """(fn(), wall seconds); the backends return host arrays, so their
    calls end synchronized."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def peak_gib(devices, reset: bool = False) -> float:
    """Largest peak allocated memory over ``devices`` in GiB (or reset the
    peaks)."""
    import torch

    devices = [d for d in devices if d.type == "cuda"]
    if reset:
        for d in devices:
            # a card nothing has allocated on yet has no allocator stats
            torch.zeros(1, device=d)
            torch.cuda.reset_peak_memory_stats(d)
        return 0.0
    return max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0) / 2**30


def in_turns(calls: dict, order=("single", "mesh", "mesh", "single")):
    """Run ``calls[name]()`` in ``order``, each after the backend's
    adaptive state is reset; returns ({name: [seconds]}, {name: last
    result})."""
    secs, last = {k: [] for k in calls}, {}
    for name in order:
        last[name], t = timed(calls[name])
        secs[name].append(t)
    return secs, last


def fmt_secs(secs: dict) -> str:
    return ", ".join(f"{k} {' / '.join(f'{t:.3f}' for t in v)} s"
                     for k, v in secs.items())


def tier_breakdown(backend, call) -> str:
    """One ``call()`` of ``backend.map_single_end``, split by the backend's
    passes (phase A, phase B, the slab tiers): per pass its reads, chunk
    count, verify slab, verify launches and wall seconds (first launch to
    the end of its fetch)."""
    from walt_tpu_torch.core import torch_backend
    from walt_tpu_torch.ops import verify

    passes = []
    real_chunks, real_fetch = backend._chunks, backend._fetch
    real_step = torch_backend.sharded.map_single_end_sharded

    def chunks(codes, lens, pattern, chunk=None):
        passes.append(dict(reads=codes.shape[0], chunks=0,
                           launches=verify.launches,
                           t0=time.perf_counter()))
        return real_chunks(codes, lens, pattern, chunk)

    def step(*a, **kw):
        passes[-1]["chunks"] += 1
        passes[-1]["slab"] = kw["verify_slab"]
        return real_step(*a, **kw)

    def fetch(tensors):
        out = real_fetch(tensors)
        p = passes[-1]
        p["secs"] = time.perf_counter() - p["t0"]
        p["launches"] = verify.launches - p["launches"]
        return out

    backend._chunks, backend._fetch = chunks, fetch
    torch_backend.sharded.map_single_end_sharded = step
    try:
        call()
    finally:
        del backend._chunks, backend._fetch
        torch_backend.sharded.map_single_end_sharded = real_step
    return "; ".join(
        f"{p['reads']} reads in {p['chunks']} chunks, slab {p['slab']}, "
        f"{p['launches']} launches, {p['secs']:.3f} s" for p in passes)


def mesh_se_parity(index, fastq, mesh, device, n_reads: int,
                   min_share: float):
    """Phase 9 (``device``: the single-device backend's).  Returns (mesh
    backend, single-device backend)."""
    from walt_tpu import native
    from walt_tpu.constants import get_pattern
    from walt_tpu.index import io_walt
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.ops import verify

    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(index)
    tables = [io_walt.read_table_cached(index + s, gm)
              for s in ("_CT00", "_CT01")]
    codes, lens = load_reads(fastq, n_reads)
    if codes.shape[0] != n_reads:
        raise AssertionError(f"{codes.shape[0]} reads loaded, not {n_reads}")
    mesh_b = TorchBackend(mesh=mesh)
    single = TorchBackend(device=device)
    devices = list(dict.fromkeys(mesh.distinct() + [single.device]))
    peak_gib(devices, reset=True)
    verify.launches = 0
    (pos, times, minus, mm, fb), t_mesh = timed(lambda: mesh_b.map_single_end(
        codes, lens, tables, 5000, 6, pattern))
    launches = verify.launches
    peak = peak_gib(devices)
    s_out, t_single = timed(lambda: single.map_single_end(
        codes, lens, tables, 5000, 6, pattern))

    def steady(b):
        b.reset_adaptive()
        return b.map_single_end(codes, lens, tables, 5000, 6, pattern)

    secs, _ = in_turns({"single": lambda: steady(single),
                        "mesh": lambda: steady(mesh_b)})
    passes = tier_breakdown(mesh_b, lambda: steady(mesh_b))
    ref = native.se_exact(codes, lens, tables, False, 5000, 6, pattern)
    if ref is None:
        raise RuntimeError("the native exact replay library is unavailable")
    ok = ~fb
    both = ok & ~s_out[4]
    for name, got, want, one in zip(("pos", "times", "minus", "mm"),
                                    (pos, times, minus, mm), ref, s_out):
        if (got[ok] != want[ok]).any():
            raise AssertionError(f"mesh {name} != native exact replay")
        if (got[both] != one[both]).any():
            raise AssertionError(f"mesh {name} != single-device backend")
    share, s_share = float(ok.mean()), float((~s_out[4]).mean())
    if launches <= 0:
        raise AssertionError("the mesh SE step never launched the kernel")
    if share < min_share:
        raise AssertionError(f"mesh device-resolved share {share:.4f} < "
                             f"{min_share}")
    say("mesh parity", f"{n_reads} reads on {mesh}: device-resolved share "
                       f"{share:.4f} (single device {s_share:.4f}), equal to "
                       f"native.se_exact on all of them and to the single "
                       f"device where neither fell back; rungs "
                       f"{mesh_b.rungs}; verify launches {launches}; first "
                       f"map_single_end (tables included) mesh "
                       f"{t_mesh:.3f} s, single {t_single:.3f} s; steady: "
                       f"{fmt_secs(secs)}; peak device memory {peak:.2f} GiB "
                       f"(mesh tables and working set); one more steady mesh "
                       f"call by pass: {passes}")
    return mesh_b, single


def mesh_pe_parity(index, pe, mesh_b, single, n_pairs: int,
                   min_share: float):
    """Phase 10."""
    import numpy as np

    from walt_tpu.constants import get_pattern
    from walt_tpu.index import io_walt

    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(index)
    tables = [[io_walt.read_table_cached(index + s, gm) for s in pair]
              for pair in (("_CT00", "_CT01"), ("_GA10", "_GA11"))]
    mates = [load_reads(fq, n_pairs) for fq in pe]
    devices = list(dict.fromkeys(mesh_b.mesh.distinct() + [single.device]))
    peak_gib(devices, reset=True)
    share, launches, t_map, t_exact = map_pairs_vs_exact(
        mesh_b, mates, tables, gm.start_index.astype(np.uint32))
    peak = peak_gib(devices)

    def both_mates(b):
        return [b.map_mate_slabs(c, n, t, ag, 5000, 6, pattern)
                for (c, n), t, ag in zip(mates, tables, (False, True))]

    _, t_single = timed(lambda: both_mates(single))
    secs, last = in_turns({"single": lambda: both_mates(single),
                           "mesh": lambda: both_mates(mesh_b)})
    s_fb = np.zeros(n_pairs, bool)
    for (ms, mfb), (ss, sfb) in zip(last["mesh"], last["single"]):
        ok = ~(mfb | sfb)
        for st, sst in zip(ms, ss):
            for k in ("cnt", "seed", "pos", "mm"):
                if (st[k][ok] != sst[k][ok]).any():
                    raise AssertionError(f"mesh PE {k} != single device")
        s_fb |= sfb
    if launches <= 0:
        raise AssertionError("the mesh PE step never launched the kernel")
    if share < min_share:
        raise AssertionError(f"mesh device-resolved pair share {share:.4f} "
                             f"< {min_share}")
    say("mesh pe parity", f"{n_pairs} pairs: device-resolved pair share "
                          f"{share:.4f} (single device "
                          f"{float((~s_fb).mean()):.4f}), finalized pairs "
                          f"equal to the exact path on all of them and "
                          f"streams equal to the single device where "
                          f"neither fell back; rungs {mesh_b.rungs}; verify "
                          f"launches {launches}; first map_mate_slabs (both "
                          f"mates, GA tables included) mesh {t_map:.3f} s, "
                          f"single {t_single:.3f} s; steady: "
                          f"{fmt_secs(secs)}; exact ranking + join "
                          f"{t_exact:.2f} s; peak device memory "
                          f"{peak:.2f} GiB")
    single.free_tables()


def same_bytes(out: str, ref: str, what: str) -> None:
    for suffix in ("", ".mapstats"):
        with open(out + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{what} output{suffix or ' (MR)'} "
                                     f"differs from the exact host path")


def fresh(*paths: str) -> None:
    for p in paths:
        open(p, "w").close()
        open(p + ".mapstats", "w").close()


def mesh_end_to_end(index, se_sub, pe_sub, mesh_b, virtual: bool,
                    n_reads: int, n_pairs: int):
    """Phase 11.  Returns (SE launches, PE launches)."""
    from walt_tpu.core.paired_end import process_paired_end
    from walt_tpu.core.single_end import process_single_end
    from walt_tpu_torch import cli
    from walt_tpu_torch.ops import verify

    work = os.path.dirname(index)
    ref, out = (os.path.join(work, f) for f in ("mesh_exact.mr", "mesh.mr"))
    ref_pe, out_pe = (os.path.join(work, f)
                      for f in ("mesh_exact_pe.mr", "mesh_pe.mr"))
    fresh(ref, out, ref_pe, out_pe)
    process_single_end(index, se_sub, ref, backend=AllFallback())
    process_paired_end(index, pe_sub[0], pe_sub[1], ref_pe,
                       backend=AllFallbackPE())
    mesh_b.reset_adaptive()
    verify.launches = 0
    _, wall = timed(lambda: process_single_end(index, se_sub, out,
                                               backend=mesh_b))
    launches = verify.launches
    same_bytes(out, ref, "mesh SE")
    mesh_b.reset_adaptive()
    verify.launches = 0
    _, wall_pe = timed(lambda: process_paired_end(
        index, pe_sub[0], pe_sub[1], out_pe, backend=mesh_b))
    launches_pe = verify.launches
    same_bytes(out_pe, ref_pe, "mesh PE")
    if launches <= 0 or launches_pe <= 0:
        raise AssertionError("a mesh end-to-end run never launched the "
                             "verify kernel")
    cli_note = "single card: the CLI's --tp has no effect, not run"
    if not virtual:
        tp_out = os.path.join(work, "mesh_cli.mr")
        if cli.main(["-i", index, "-r", se_sub, "-1", pe_sub[0], "-2",
                     pe_sub[1], "-o", f"{tp_out},{tp_out}.pe",
                     "--tp", "2"]) != 0:
            raise AssertionError("the CLI --tp 2 run failed")
        same_bytes(tp_out, ref, "CLI --tp 2 SE")
        same_bytes(tp_out + ".pe", ref_pe, "CLI --tp 2 PE")
        cli_note = "the CLI's --tp 2 over all cards: byte-identical too"
    say("mesh e2e", f"process_single_end {n_reads / wall:.1f} reads/s "
                    f"({wall:.2f} s for {n_reads} reads, tables cached), "
                    f"verify launches {launches}; process_paired_end "
                    f"{n_pairs / wall_pe:.1f} pairs/s ({wall_pe:.2f} s for "
                    f"{n_pairs} pairs), verify launches {launches_pe}; MR "
                    f"and .mapstats byte-identical to the exact host path; "
                    f"{cli_note}")
    mesh_b.free_tables()
    return launches, launches_pe


def mesh_dryrun() -> None:
    """Phase 12."""
    from walt_tpu_torch import entry

    out, wall = timed(lambda: entry.dryrun_multichip(4))
    say("dryrun", f"entry.dryrun_multichip(4) passed in {wall:.2f} s: {out}")


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
    index, fastq, pe = build_data(DATA, GENOME_BASES, N_READS, N_PAIRS,
                                  READ_LEN)
    backend_parity(index, fastq, device, MIN_DEVICE_SHARE)
    launches, _ = end_to_end(index, fastq, device, N_READS)
    pe_parity(index, pe, device, MIN_DEVICE_SHARE)
    launches_pe, _ = pe_end_to_end(index, pe, device, N_PAIRS)

    mesh, virtual = smoke_mesh()
    say("mesh", f"{mesh} ({'virtual, on one card' if virtual else 'real'}); "
                f"{N_MESH_READS} reads, {N_MESH_PAIRS} pairs")
    se_sub = head_fastq(fastq, os.path.join(DATA, "mesh_reads.fq"),
                        N_MESH_READS)
    pe_sub = tuple(head_fastq(f, os.path.join(DATA, f"mesh_pairs_{i}.fq"),
                              N_MESH_PAIRS) for i, f in enumerate(pe, 1))
    mesh_b, single = mesh_se_parity(index, se_sub, mesh, device,
                                    N_MESH_READS, MIN_DEVICE_SHARE)
    mesh_pe_parity(index, pe_sub, mesh_b, single, N_MESH_PAIRS,
                   MIN_MESH_PE_SHARE)
    launches_mesh, launches_mesh_pe = mesh_end_to_end(
        index, se_sub, pe_sub, mesh_b, virtual, N_MESH_READS, N_MESH_PAIRS)
    mesh_dryrun()

    if "jax" in sys.modules:
        raise AssertionError("walt_tpu_torch imported jax")
    print(json.dumps({"kernels": [{
        "name": "verify_windows", "route": "cuda",
        "source": "walt_tpu_torch/csrc/verify.cu",
        "replaces": "walt_tpu/ops/pallas_verify.py:93",
        "launches": launches, "launches_pe": launches_pe,
        "launches_mesh": launches_mesh, "launches_mesh_pe": launches_mesh_pe,
        "max_abs_err": err,
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
