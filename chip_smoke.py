#!/usr/bin/env python3
"""Smoke test of walt_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero).
The numbers name the phases; ``main`` runs them in the order 1-9, 17,
10-13, 15, 16, 18, 19 (there is no phase 14):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels (csrc/) with nvcc into build/kernels/;
3. kernel vs plain: every kernel against its plain PyTorch version on the
   card, exact equality, at the SE and PE main-path shapes and at edge
   shapes: ``verify_windows`` (K1) on random rows, and ``verify_worklist``
   (the fused verify stage, the main path's kernel) on synthetic worklists
   in read order with chromosome edges and verify_skip rows.  Times each at
   the SE main-path shape, as device time (torch.profiler, each window
   after a warm-up call in the profiler's warm-up step) and as wall time
   per wrapper call (CUDA events); the fused stage in turns with the chain
   it replaced (the torch ops around K1: chain, kernel, kernel, chain) and
   with its plain version, with the device events per call of each.  Each
   kernel's window must hold exactly one device event per call (a short
   window is profiled again, at most PROFILE_ATTEMPTS times; each kernel
   line prints the attempts its windows took);
4. data: a 128 Mbp repetitive synthetic genome (about the size of the
   Arabidopsis thaliana genome, a standard WGBS organism), its WALT index,
   1,000,000 x 100 bp bisulfite reads and 500,000 x 100 bp bisulfite read
   pairs (fragments 150-500 bp), built once into build/smoke_data/;
5. SE backend parity: TorchBackend.map_single_end on all reads == the
   native exact replay on every read the device resolved, with a
   device-resolved share of at least 75%; then the uniq build alone on the
   CT00 table (128M entries): its time, and its peak memory above the
   placed table and its outputs (at most MAX_UNIQ_BUILD_GIB);
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

13. positions past 2^31: phase 4's index behind a filler chromosome of
    FILLER bases (2,243,483,648 positions; written once, no second index
    build): every table is phase 4's with FILLER added to each entry.  The
    CLI maps the 1M reads and the 500k pairs in one run (one backend):
    MR and .mapstats byte-identical to phases 6 and 8's exact host path,
    with the device-resolved shares of phases 5 and 7 (phases 6 and 8's
    CLI shares must equal them too); then process_single_end on the
    250,000 mesh reads, virtual meshes on one card with the tp and accel that hbm_plan.plan_tables
    picks for this genome on this card, and tp=2 with key16: byte-identical
    to phase 11's exact host path.  Prints the largest genome position the
    device emitted (at least 2^31).

15. other shapes and the memory ladder (after phase 13, on phase 11's
    250,000 reads and 125,000 pairs, fresh backends, the environment
    restored after each run): SE at chunk 65,536, ``verify_slab_t1`` 16
    and ``_wl1`` 1.25, under a ``WALTX_HBM_GB`` that fits both tables'
    key16 key words but not the uniq runs or u32 word 0; PE at the mate
    step's shapes 8 / 2 / 8 (``pe_verify_slab``, ``pe_wl``,
    ``pe_flat_factor``, set on the backend) under a ``WALTX_HBM_GB`` under
    which all four tables take u32 word 0.  The backend's own ladder must
    pick those rungs, MR and .mapstats must equal phase 11's exact host
    path byte for byte, and each run must launch the fused stage and not
    K1.  Prints one ``knobs`` line: rung per table, shares, launches and
    seconds.

16. dp scaling (after phase 15, on phase 4's index): the measurement of
    ``tools/dp_scaling_torch.py`` on 131,072 reads per mesh size, 2 reps
    each, without its end-to-end calls: dp = 1, 2 and 4 at tp = 1 (rows
    over the cards when the machine has as many, else virtual on card 0;
    each dp row on a host thread of its own), then tp = 1 against tp = 2.  Each dp program's result must
    equal its serial chunks' element for element, with the same fused
    stage launches and no K1, and the main thread's current CUDA device
    must be what it was.  Prints one ``dp`` line: per mesh size the device
    program's reads/s, its implied (virtual) or real efficiency and its
    launches.

17. CUDA graphs (run right after phase 9, on the CT00 and CT01 tables
    its backends built): one 131,072-read chunk through the SE step and
    one of mate-1 reads through the PE mate step, on one card and on the
    mesh, as the backend runs them (graph replays of its ``ops/graphs``
    step cache) and eagerly (one card: with an ``ops/stages`` recorder;
    the mesh: its rows' parts run one op at a time).  Bit-identical, and
    k replays count k times the eager step's fused-stage launches.  Prints
    one ``graphs`` line: per step the wall and device busy ms of the graph
    and of the eager step, their idle shares, and the cached graphs and
    their pools' bytes per device.

18. hg19 tool (after phase 16, ~1-2 min): ``tools/hg19_scale_torch.py``
    on card 0 at HG19_BP bases, HG19_READS reads of 100 bp and of 150 bp
    and as many pairs of 2x100 and 2x150 bp, its plans under
    HG19_ENTRY_LIMIT (a
    shard's entry limit scaled to this genome, which refuses tp=1 and 2)
    and a memory budget under which the SE plan (two tables) splits them
    tp=4 with the uniq index and the PE plan (four) tp=4 with key16 (a
    virtual mesh on the one card), GA10 and GA11 through a spill
    directory, work and report in a temporary directory.  Every parity of
    the tool must hold (mesh at both lengths and the CLI against the exact
    host path, SE and PE), each read set's fallback must stay below 100%,
    each pair set's device-resolved pair share above 0, each run must
    launch the fused stage and never K1, and no batch may go to the host
    after a device out-of-memory error.  Prints one ``hg19`` line: the
    plans, per length reads/s or pairs/s, fallback or pair share and
    launches, the CLIs' rates, and per device SE / PE the tables, working
    set, graphs and pool bytes.

19. seed patterns 5 and 7 (last, the short-read deployment): phase 4's
    genome indexed under pattern 7 by ``python -m walt_tpu_torch.cli index
    --seed-pattern 7`` (build time and each file's sha256 printed, every
    entry inside the genome), and a P5_BP-base repetitive genome (seed 43)
    under pattern 5.  Pattern 7: P7_READS reads sampled at READ_LEN (seed
    13) with their 3' ends trimmed to 23-100 bp (numpy seed 19) and
    P7_SHORT reads of 15-22 bp, which must count as too short; P7_PAIRS
    pairs of 2x50 bp (fragments 100-300 bp, seed 17).  Pattern 5: P5_READS
    x 100 bp reads and P5_PAIRS pairs of 2x100 bp.  The CLI on the card,
    pattern 7 SE with ``-a -u`` and with ``-A -sam``, PE default and
    ``-sam``, pattern 5 SE and PE default: every output file byte-identical
    to the exact host path with the same flags, each run launching the
    fused stage and never K1, with no batch mapped on the host after a
    device OOM and a device-resolved share above 0; the card's
    ``map_single_end`` arrays equal a CPU TorchBackend's on the first
    P7_PARITY_READS pattern-7 reads; then the graph-pool watch: one backend
    maps WATCH_READS reads of each WATCH_LENGTHS length under pattern 7,
    then pattern 3, printing its graphs and pool bytes after each, and
    fails when its working set passes HBM_RESERVE.  Prints per run the CLI
    rate with and without the table setup, the shares (SE by length
    class), launches, graphs and pool bytes.

The backends run every device step as a CUDA graph replay; the kernel's
launch counters count each replay's captured launches, so a count is the
number of times the kernel ran.  Phases 5, 7, 9, 10, 18 and 19 print the
working set, the peak reserved device memory less the resident tables'
bytes and less what earlier phases still hold (the graphs' pools
included); the largest sets ``TorchBackend.HBM_RESERVE``, and the script
fails if one exceeds it.

Each phase that drives the main path sets every kernel's launch count to
0 just before and reads the counts just after; it fails unless the fused
stage was launched.  The last two lines are one JSON object describing the
kernels (``ms`` and ``plain_ms`` are device time per call at the SE shape,
``wall_ms`` and ``plain_wall_ms`` wall time per call, ``bound_ms`` the
least time the card could take for the same work from the bytes these
inputs need at 3.35 TB/s or their integer operations, whichever is larger;
``launches`` and ``launches_pe`` count the launches of the timed SE and PE
CLI runs, ``launches_mesh`` and ``launches_mesh_pe`` those of phase 11's SE
and PE runs, ``launches_shifted`` and ``launches_shifted_mesh`` those of
phase 13's CLI run and mesh runs, ``launches_dp`` those of phase 16,
``launches_hg19`` and ``launches_hg19_pe`` those of phase 18's SE and PE
runs (mesh and CLI), ``launches_p7_se_au``, ``launches_p7_se_Asam``,
``launches_p7_pe``, ``launches_p7_pe_sam``, ``launches_p5_se``,
``launches_p5_pe`` and ``launches_watch`` those of phase 19's CLI runs
and its graph-pool watch;
``chain_ms`` is the replaced chain's device time) and one JSON object
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
#: reads per main-path chunk (the worklists' B)
MAIN_B = 131_072
#: the H100 SXM's published memory rate, and its int32 rate (64 INT32 lanes
#: per SM: half the 67 TFLOP/s float32 rate outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 33.5e12
#: the PE mate step's verify shape: worklist factor 3 x the 131,072-read
#: chunk
PE_M = 393_216
#: reads and pairs of the mesh phases 9-11 (the first of phase 4's)
N_MESH_READS = 250_000
N_MESH_PAIRS = 125_000
#: pair share the tp=2 mesh must resolve on the device.  Lower than
#: MIN_DEVICE_SHARE: the PE step has no device tiers for the reads a
#: shard's routed rows (int(1.25 * pairs / T) + 128) or worklist spill.
#: Under walt_tpu's equal bucket-key ranges one of two shards owned about
#: 2/3 of a converted read's (read, seed) pairs, past the rows' 5/8 (0.6849
#: measured on an H100); the port's entry-balanced ranges give each about
#: half
MIN_MESH_PE_SHARE = 0.65
#: the uniq build's peak device memory above its table and outputs
MAX_UNIQ_BUILD_GIB = 0.5
#: profiling windows tried before a kernel's or a stage's device record
#: counts as incomplete (the profiler can lose a window's first records)
PROFILE_ATTEMPTS = 5
#: the attempts each complete profiling window took, in order (phase 3's
#: ``kernel`` lines print their windows')
profile_attempts = []
#: phase 13's filler chromosome in front of phase 4's genome: a multiple of
#: 16 (the packed words keep their bits), so phase 4's first chromosome
#: straddles 2^31 and the genome ends at 2,243,483,648 < 2^32
FILLER = (1 << 31) - 32_000_000


def zero_counts() -> None:
    """Every kernel's launch count to 0."""
    from walt_tpu_torch.ops import verify

    verify.stage_launches = 0
    verify.launches = 0


def counts() -> dict:
    """Every kernel's launch count since :func:`zero_counts`."""
    from walt_tpu_torch.ops import verify

    return {"verify_worklist": verify.stage_launches,
            "verify_windows": verify.launches}


def say(phase: str, msg: str) -> None:
    print(f"[chip_smoke] {phase}: {msg}", flush=True)


def start_memory(device, *backends) -> int:
    """Free what earlier phases left unreachable (a reference cycle keeps a
    backend and its tables until the collector runs), release the
    allocator's cached blocks and reset the peaks, so the next peak is what
    the following work needs.  Returns the bytes still allocated outside
    the ``backends``' tables: what earlier work holds, which
    :func:`working_set` leaves out."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return (torch.cuda.memory_allocated(device)
            - sum(b.table_bytes(device) for b in backends))


def working_set(device, held: int, *backends) -> float:
    """Peak reserved device memory since :func:`start_memory` less what
    earlier work ``held`` then (its return value) and the backends'
    resident tables, in GiB: what mapping needs beside its tables (chunks,
    worklists, build temporaries, the allocator's caching)."""
    import torch

    reserved = torch.cuda.max_memory_reserved(device) - held
    return (reserved - sum(b.table_bytes(device) for b in backends)) / 2**30


class Recorder:
    """While active, keeps the backend ``backends.get_backend`` makes (the
    CLI's) and what its ``map_single_end`` and ``map_mate_slabs_finish``
    calls return: the fallback masks and device positions a CLI run does
    not print.  :meth:`watch` does the same for a backend made here."""

    def __init__(self):
        self.backend, self.se, self.pe = None, [], []

    def watch(self, backend):
        self.backend = backend
        for name, into in (("map_single_end", self.se),
                           ("map_mate_slabs_finish", self.pe)):
            fn = getattr(backend, name)

            def wrapped(*a, _fn=fn, _into=into, **k):
                out = _fn(*a, **k)
                _into.append(out)
                return out

            setattr(backend, name, wrapped)
        return backend

    def __enter__(self):
        from walt_tpu_torch.core import backends

        self._real = backends.get_backend
        backends.get_backend = lambda *a, **k: self.watch(self._real(*a, **k))
        return self

    def __exit__(self, *exc):
        from walt_tpu_torch.core import backends

        backends.get_backend = self._real
        if self.backend is not None:
            # the wrappers hold the backend's bound methods: a cycle that
            # would keep the backend and its tables on the card until the
            # collector runs
            for name in ("map_single_end", "map_mate_slabs_finish"):
                self.backend.__dict__.pop(name, None)

    def se_share(self) -> float:
        import numpy as np

        return float((~np.concatenate([o[4] for o in self.se])).mean())

    def pe_share(self) -> float:
        """Pairs neither mate sent to fallback (mates finish in order)."""
        import numpy as np

        fb = [o[1] for o in self.pe]
        return float((~np.concatenate([a | b for a, b in
                                       zip(fb[0::2], fb[1::2])])).mean())

    def max_position(self) -> int:
        """The largest genome position of a device-resolved result."""
        import numpy as np

        top = [int(p[~fb & (t > 0)].max(initial=0))
               for p, t, _, _, fb in self.se]
        for streams, fb in self.pe:
            for st in streams:
                used = (np.arange(st["pos"].shape[1])[None, :]
                        < st["cnt"][:, None]) & ~fb[:, None]
                top.append(int(st["pos"][used].max(initial=0)))
        return max(top, default=0)


def card_lines() -> list:
    """nvidia-smi's name and power limit of each card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


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


def device_profile(fn, reps: int = 20, events: int | None = None):
    """(mean device milliseconds, device events) per call of ``fn``: the
    summed durations and the count of the device events launched by
    ``reps`` calls in one torch.profiler window.  One call runs first, in
    the profiler's warm-up step (``ops/stages.profiled``): on an H100 a
    window opened without it lost its first device records.  Only device
    events whose launching host call lies in the window count (matched by
    correlation id).  A window that holds no device event, or, with
    ``events``, does not hold exactly that many per call or lost the device
    record of one of its launches, is profiled again, at most
    PROFILE_ATTEMPTS times."""
    from walt_tpu_torch.ops import stages as st

    trace = os.path.join(ROOT, "build", "device_profile_trace.json")
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        _, evs = st.profiled(lambda: [fn() for _ in range(reps)], fn, trace)
        os.unlink(trace)
        launched = {e["args"]["correlation"]: e["name"] for e in evs
                    if e.get("cat") in st.LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        dev = [e for e in evs if e.get("cat") in st.DEVICE_CATS
               and e.get("args", {}).get("correlation") in launched]
        got = {e["args"]["correlation"] for e in dev}
        lost = sum(1 for c, name in launched.items() if c not in got
                   and any(w in name for w in st.LAUNCH_WORDS))
        per_call = len(dev) / reps
        if dev and (events is None or (per_call == events and not lost)):
            profile_attempts.append(attempt)
            return sum(float(e["dur"]) for e in dev) / 1e3 / reps, per_call
        say("kernel", f"profiling window {attempt}: {per_call} device events "
                      f"per call (want {events or 'some'}), {lost} launches "
                      f"without their device record; profiling again")
    raise AssertionError(f"no profiling window in {PROFILE_ATTEMPTS} held "
                         f"{events or 'any'} device events per call")


def device_ms(fn, reps: int = 20, events: int | None = None) -> float:
    """Mean device milliseconds per call of ``fn`` (:func:`device_profile`)."""
    return device_profile(fn, reps, events)[0]


def bound(n_bytes: float, n_ops: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the integer operations over the int32 rate."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def windows_bound(args, W: int):
    """verify_windows' bound on these inputs: gpos, conv and lane read once,
    the distinct genome words the windows touch, mm and win written once;
    about 7 integer operations per word."""
    import torch

    pseq, gpos, conv, lane = args
    M = gpos.shape[0]
    words = ((gpos.long() & 0xFFFFFFFF) >> 4)[:, None] + torch.arange(
        W + 1, device=gpos.device)
    n_words = torch.unique(words.clamp_(max=pseq.shape[0] - 1)).numel()
    n_bytes = 4 * M + 8 * M * W + 4 * n_words + 4 * M + 4 * M * W
    return bound(n_bytes, M * (7 * W + 5))


def stage_bound(args, kw):
    """verify_worklist's bound on these inputs, counted once: each row's
    three int64 indices and valid flag, the distinct index entries and
    genome words the rows touch, the conv words, length and repeat count of
    each distinct read, start_index, and gpos, mm (int64) and keep written;
    about 14 integer operations per word and 60 per row."""
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


def stage_inputs(rng, M: int, B: int, W: int, Wg: int, device, *,
                 n_chroms: int = 4, n_index: int = 1 << 16,
                 seeds=None, key16: bool = False, check: bool = True,
                 valid_share: float = 0.85, straddle: bool = False,
                 pattern: str = "3"):
    """Inputs of ``verify.verify_worklist``: a synthetic worklist of M rows
    over B reads of W words, in read order (valid rows first, then the
    invalid tail on read 0, as the pipeline's compaction leaves them),
    against a random Wg-word genome of ``n_chroms`` chromosomes.  Index
    entries sit at chromosome starts (wrapped ``ok_head`` rows, gpos >= 2^31
    at the genome start), at chromosome ends (``ok_tail``), at the genome
    end (window clamp) and past it; half the reads copy the genome window of
    their first row with a few mismatches, so ``mm <= max_mm``, the
    verify_skip lanes (base 70 on shift 2, pattern 3's) and the cared
    check all decide some rows; lengths run from 0 (reads shorter than the
    pattern's minimum included) to 16 W, 40% of them min(100, 16 W) (a
    read that fills its W words when W < 7).  ``pattern``: the seed
    pattern's tables (``seeds``: its shifts, all of them by default).
    ``check``: the window cared check runs (``key16``: from cared position
    kw + 8).  ``straddle``: the random words start at base
    2^31 - 8 Wg behind zero words, so index values and chromosome starts
    lie on both sides of 2^31 (the first chromosome spans the zeros).
    Returns (args, kwargs) of the call."""
    import numpy as np
    import torch

    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.ops import packing, pipeline

    pattern = get_pattern(pattern)
    seeds = tuple(range(pattern.pattern_len)) if seeds is None else seeds
    plen, S = pattern.pattern_len, len(seeds)
    G = Wg * 16 - 32  # genome bases; the last words clamp windows
    base = (1 << 31) - 16 * (Wg // 2) if straddle else 0
    cuts = np.sort(rng.choice(np.arange(1, G), n_chroms - 1, replace=False))
    si = np.concatenate([[0], base + cuts, [base + G]]).astype(np.uint32)
    pseq = rng.integers(0, 1 << 32, Wg, dtype=np.uint32)
    if base:
        pseq = np.concatenate([np.zeros(base // 16, np.uint32), pseq])
    index = (base + rng.integers(0, G, n_index)).astype(np.uint32)
    k = max(1, n_index // 16)
    ch = rng.integers(0, n_chroms, 2 * k)
    index[:k] = si[ch[:k]] + rng.integers(0, 3, k)  # chromosome starts
    index[k:2 * k] = np.maximum(si[ch[k:] + 1].astype(np.int64)
                                - rng.integers(1, 120, k), 0)  # ends
    index[2 * k:2 * k + 8] = [0, 1, base + G - 1, base + G - 5,
                              base + Wg * 16 - 3,
                              0x80000000, 0x9000000F, 0xFFFFFFF1]
    rng.shuffle(index[8:])

    # rows as the compaction orders them: by read, then seed, then bucket
    # entry; the rows of one (read, seed) are consecutive index entries
    n_valid = int(valid_share * M)
    wl_read = np.zeros(M, np.int64)
    wl_seedi = np.zeros(M, np.int64)
    key = np.sort(rng.integers(0, B, n_valid) * S + rng.integers(0, S, n_valid))
    wl_read[:n_valid], wl_seedi[:n_valid] = key // S, key % S
    start = np.r_[True, key[1:] != key[:-1]]
    run = np.arange(n_valid) - np.maximum.accumulate(
        np.where(start, np.arange(n_valid), 0))
    wl_entryidx = np.full(M, -1, np.int64)
    wl_entryidx[:n_valid] = rng.integers(0, n_index, n_valid)[
        np.maximum.accumulate(np.where(start, np.arange(n_valid), 0))] + run
    wl_entryidx[n_valid:] = wl_entryidx[0]
    if M > 4:
        wl_entryidx[1:3] = [-1, n_index + 5]  # clamped gathers
    wl_valid = np.arange(M) < n_valid

    Lmax = 16 * W
    lens = rng.integers(0, Lmax + 1, B)
    lens[rng.random(B) < 0.4] = min(100, Lmax)
    short = rng.random(B) < 0.1
    lens[short] = rng.integers(0, pattern.min_read_len, int(short.sum()))
    repeats = np.minimum((lens - plen + 1) // plen, pattern.max_repeats())

    conv = rng.integers(0, 1 << 32, (B, W), dtype=np.uint32).astype(np.int64)
    first = np.flatnonzero(np.r_[True, wl_read[1:n_valid]
                                 != wl_read[:n_valid - 1]]) if n_valid else []
    own = [m for m in first if rng.random() < 0.5]
    if own:
        own = np.asarray(own)
        ent = index[np.clip(wl_entryidx[own], 0, n_index - 1)].astype(np.int64)
        gpos = (ent - np.asarray(seeds)[wl_seedi[own]]) & 0xFFFFFFFF
        win = packing.window_words(packing.from_np(pseq),
                                   torch.from_numpy(gpos), W).numpy()
        for i in range(win.shape[0]):  # a few mismatches, base 70 often
            for pos in rng.integers(0, Lmax, rng.integers(0, 4)).tolist() + (
                    [70] if Lmax > 70 and rng.random() < 0.5 else []):
                win[i, pos // 16] ^= 1 << (30 - 2 * (pos % 16))
        conv[wl_read[own]] = win
    cared = (pipeline.window_cared_mask(pattern, seeds, W, key16)
             if check else None)
    cwt = pattern.cared_weight
    kw = dict(seeds=tuple(seeds), verify_skip=pattern.verify_skip,
              cared_mask=cared, cared_off=pattern.cared[:cwt], max_mm=6,
              plen=plen, cwt=cwt,
              n_cared=min(pattern.cared_size, pattern.key_weight + 48))
    dev = torch.device(device)
    t64 = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (wl_read, wl_seedi, wl_entryidx)]
    args = (*t64, torch.from_numpy(wl_valid).to(dev),
            torch.from_numpy(conv).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(repeats).to(dev),
            *(packing.from_np(a, dev) for a in (index, pseq, si)))
    return args, kw


def check_verify_kernel(device, Wg: int):
    """Phase 3: kernel == plain on every listed shape; times at the SE
    main shape (and device time at the PE one).  Returns (max_abs_err,
    kernel device ms, plain device ms, kernel wall ms per call, plain wall
    ms per call), all at the SE main shape."""
    import numpy as np
    import torch

    from walt_tpu_torch.ops import packing, verify

    rng = np.random.default_rng(2024)
    window0 = len(profile_attempts)
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
    # the kernel's windows hold exactly one device event per call
    dp1, dk1, dk2, dp2 = (device_ms(f, events=1 if f is kern else None)
                          for f in (plain, kern, kern, plain))
    pe_args = verify_inputs(rng, PE_M, MAIN_W, Wg, device)
    pe_k = device_ms(lambda: verify.verify_windows(*pe_args, MAIN_W),
                     events=1)
    pe_p = device_ms(lambda: verify.verify_windows_reference(*pe_args,
                                                             MAIN_W))
    k_bound = windows_bound(args, MAIN_W)
    pe_bound = windows_bound(pe_args, MAIN_W)
    say("kernel", f"verify_windows == plain on {len(shapes)} shapes "
                  f"(sh 0..30, end clamp, gpos >= 2^31); at M={MAIN_M} "
                  f"W={MAIN_W}: device time (torch.profiler) kernel "
                  f"{dk1 * 1e3:.1f}/{dk2 * 1e3:.1f} us, plain "
                  f"{dp1 * 1e3:.1f}/{dp2 * 1e3:.1f} us per call; wall per "
                  f"call (CUDA events over 50 calls, launch-bound) kernel "
                  f"{k1 * 1e3:.1f}/{k2 * 1e3:.1f} us, plain "
                  f"{p1 * 1e3:.1f}/{p2 * 1e3:.1f} us; at the PE shape "
                  f"M={PE_M}: device time kernel {pe_k * 1e3:.1f} us, plain "
                  f"{pe_p * 1e3:.1f} us per call; bound at M={MAIN_M} "
                  f"{k_bound[0] * 1e3:.2f} us ({k_bound[1]}), at M={PE_M} "
                  f"{pe_bound[0] * 1e3:.2f} us; profiling attempts per "
                  f"window {profile_attempts[window0:]}")
    return dict(max_abs_err=err, ms=(dk1 + dk2) / 2, plain_ms=(dp1 + dp2) / 2,
                wall_ms=(k1 + k2) / 2, plain_wall_ms=(p1 + p2) / 2,
                bound_ms=k_bound[0], bound_by=k_bound[1], pe_ms=pe_k,
                pe_plain_ms=pe_p, pe_bound_ms=pe_bound[0])


#: fused-stage shapes (M, B, W, stage_inputs options): the SE and PE main
#: path, then edges: key16's and exact_b's cared checks, phase A's one seed,
#: W from 1 to 16 (template instances) and 17 and 63 (the runtime-W
#: instance), more chromosome starts than shared memory holds (2048),
#: reads too sparse for the staged conv range, a ragged last block; then
#: genomes whose index values and chromosome starts pass 2^31, with one
#: chromosome or with hg19's 93 contigs, at the SE shape and at edges; then
#: seed patterns 5 (S = 5, cared_weight 2) and 7 (S = 7, cared_weight 4,
#: exit1 seed 4), neither with verify_skip triples: pattern 5 at W = 7,
#: pattern 7 at W = 2 and 3 (23-48 bp reads, many filling their words)
#: and at W = 7, with and without the window cared check
STAGE_SHAPES = [
    (MAIN_M, MAIN_B, MAIN_W, {}), (PE_M, MAIN_B, MAIN_W, {}),
    (5003, 3000, 7, dict(key16=True)), (5003, 3000, 7, dict(check=False)),
    (5003, 3000, 7, dict(seeds=(0,))), (5003, 3000, 1, {}),
    (5003, 3000, 3, {}), (5003, 3000, 13, {}), (5003, 3000, 16, {}),
    (4097, 2000, 17, {}), (4097, 2000, 63, {}),
    (2000, 1000, 7, dict(n_chroms=3000)), (600, 60_000, 7, {}),
    (255, 100, 7, {}),
    (MAIN_M, MAIN_B, MAIN_W, dict(straddle=True, n_chroms=93)),
    (5003, 3000, 7, dict(straddle=True, n_chroms=1)),
    (5003, 3000, 7, dict(straddle=True, n_chroms=93, key16=True)),
    (4097, 2000, 17, dict(straddle=True, n_chroms=93)),
    (5003, 3000, 7, dict(pattern="5")),
    (5003, 3000, 7, dict(pattern="5", check=False)),
    (5003, 3000, 2, dict(pattern="7")), (5003, 3000, 3, dict(pattern="7")),
    (5003, 3000, 7, dict(pattern="7")),
    (5003, 3000, 7, dict(pattern="7", check=False)),
    (MAIN_M, MAIN_B, MAIN_W, dict(pattern="7")),
]


def check_stage_kernel(device, Wg: int):
    """Phase 3, the fused stage: verify_worklist == its plain version
    exactly on every STAGE_SHAPES entry; at the SE shape, device and wall
    time of the kernel in turns with the chain it replaced (the port's
    earlier torch ops around K1), and of its plain version, with device
    events per call; device time at the PE shape.  Returns the kernel's
    numbers for the kernels line."""
    import numpy as np
    import torch

    from walt_tpu_torch.ops import verify

    rng = np.random.default_rng(2025)
    window0 = len(profile_attempts)
    main = {}
    past = 0  # kept windows at or past 2^31
    for M, B, W, opts in STAGE_SHAPES:
        big = M >= MAIN_M
        args, kw = stage_inputs(rng, M, B, W, Wg if big else 1 << 16, device,
                                n_index=1 << 24 if big else 1 << 16, **opts)
        got = verify.verify_worklist(*args, **kw)
        want = verify.verify_worklist_reference(
            *args, **kw, windows=verify.verify_windows_reference)
        torch.cuda.synchronize()
        for name, g, w in zip(("gpos", "mm", "keep"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"verify_worklist {name} != plain at "
                                     f"M={M} B={B} W={W} {opts}: {bad} rows")
        if opts.get("straddle"):
            past += int((got[0][got[2]] >= 1 << 31).sum())
        elif big:
            main[opts.get("pattern", "3"), M] = (args, kw)
        del args, got, want
    args, kw = main["3", MAIN_M]
    kern = lambda: verify.verify_worklist(*args, **kw)  # noqa: E731
    chain = lambda: verify.verify_worklist_reference(*args, **kw)  # noqa: E731
    plain = lambda: verify.verify_worklist_reference(  # noqa: E731
        *args, **kw, windows=verify.verify_windows_reference)
    c1, k1, k2, c2 = (device_profile(f, events=1 if f is kern else None)
                      for f in (chain, kern, kern, chain))
    p1 = device_profile(plain)
    wc1, wk1, wk2, wc2 = (cuda_ms(f) for f in (chain, kern, kern, chain))
    wp1 = cuda_ms(plain)
    pe_args, pe_kw = main["3", PE_M]
    pe_k = device_ms(lambda: verify.verify_worklist(*pe_args, **pe_kw),
                     events=1)
    p7_args, p7_kw = main["7", MAIN_M]
    p7_k = device_ms(lambda: verify.verify_worklist(*p7_args, **p7_kw),
                     events=1)
    p7_p = device_ms(lambda: verify.verify_worklist_reference(
        *p7_args, **p7_kw, windows=verify.verify_windows_reference))
    p7_b_ms, p7_b_by = stage_bound(p7_args, p7_kw)
    pe_c = device_ms(lambda: verify.verify_worklist_reference(*pe_args,
                                                              **pe_kw))
    b_ms, b_by = stage_bound(args, kw)
    pe_b_ms, _ = stage_bound(pe_args, pe_kw)
    valid = float(args[3].float().mean())
    say("kernel", f"verify_worklist == plain on {len(STAGE_SHAPES)} shapes "
                  f"(SE, PE, key16, exact_b, seed 0, W 1/3/7/13/16/17/63, "
                  f"3000 chromosomes, sparse reads, ragged block, "
                  f"genomes past 2^31 with 1 or 93 chromosomes: {past} kept "
                  f"windows at or past 2^31, and seed patterns 5 and 7 at "
                  f"W 2/3/7, the SE shape included); at "
                  f"M={MAIN_M} B={MAIN_B} W={MAIN_W} ({valid:.2f} valid): "
                  f"device time (torch.profiler) kernel "
                  f"{k1[0] * 1e3:.1f}/{k2[0] * 1e3:.1f} us in "
                  f"{k1[1]:.0f} device events, the replaced chain "
                  f"{c1[0] * 1e3:.1f}/{c2[0] * 1e3:.1f} us in {c1[1]:.0f} "
                  f"events, plain {p1[0] * 1e3:.1f} us in {p1[1]:.0f} events "
                  f"per call; wall per call (CUDA events) kernel "
                  f"{wk1 * 1e3:.1f}/{wk2 * 1e3:.1f} us, chain "
                  f"{wc1 * 1e3:.1f}/{wc2 * 1e3:.1f} us, plain "
                  f"{wp1 * 1e3:.1f} us; bound {b_ms * 1e3:.2f} us ({b_by}), "
                  f"kernel at {100 * b_ms / ((k1[0] + k2[0]) / 2):.0f}% of "
                  f"it; at the PE shape M={PE_M}: kernel {pe_k * 1e3:.1f} us, "
                  f"chain {pe_c * 1e3:.1f} us, bound {pe_b_ms * 1e3:.2f} us; "
                  f"at the SE shape under pattern 7 (S = 7): kernel "
                  f"{p7_k * 1e3:.1f} us, plain {p7_p * 1e3:.1f} us, bound "
                  f"{p7_b_ms * 1e3:.2f} us ({p7_b_by}); "
                  f"profiling attempts per window "
                  f"{profile_attempts[window0:]}")
    if not past:
        raise AssertionError("no fused-stage shape kept a window past 2^31")
    return dict(max_abs_err=0, ms=(k1[0] + k2[0]) / 2, plain_ms=p1[0],
                chain_ms=(c1[0] + c2[0]) / 2, wall_ms=(wk1 + wk2) / 2,
                plain_wall_ms=wp1, chain_wall_ms=(wc1 + wc2) / 2,
                bound_ms=b_ms, bound_by=b_by, events=k1[1],
                chain_events=c1[1], pe_ms=pe_k, pe_chain_ms=pe_c,
                pe_bound_ms=pe_b_ms, p7_ms=p7_k, p7_plain_ms=p7_p,
                p7_bound_ms=p7_b_ms)


def build_data(data_dir: str, n_bases: int, n_reads: int, n_pairs: int,
               read_len: int):
    """Phase 4: genome FASTA, 5-file WALT index, SE FASTQ and the two PE
    FASTQs, each built once (the SE set and the PE set under stamps of
    their own).  Returns (index, fastq, (fastq_1, fastq_2))."""
    from walt_tpu_torch.index.build import build_all_tables
    from walt_tpu_torch.index.io_walt import write_index
    from walt_tpu_torch.synth import (
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

    from walt_tpu_torch import native, perf
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.host.fastq import FgetsLines, load_batch
    from walt_tpu_torch.index import io_walt
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
    held = start_memory(device)
    zero_counts()
    reads0 = perf.counters().get("backend.reads", 0)
    t0 = time.perf_counter()
    pos, times, minus, mm, fb = backend.map_single_end(
        codes, lens, tables, 5000, 6, pattern)
    t1 = time.perf_counter()
    launches = counts()
    peak = torch.cuda.max_memory_allocated(device)
    ws = working_set(device, held, backend)
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
    reads = perf.counters().get("backend.reads", 0) - reads0
    if reads != n:
        raise AssertionError(f"backend.reads {reads} != {n}")
    if launches["verify_worklist"] <= 0:
        raise AssertionError("the mapping never launched the verify kernel")
    if share < min_share:
        raise AssertionError(f"device-resolved share {share:.4f} < "
                             f"{min_share}")
    say("parity", f"{n} reads: device-resolved share {share:.4f}, equal to "
                  f"native.se_exact on all of them; rung {backend.rungs}; "
                  f"verify launches {launches}; map_single_end "
                  f"{t1 - t0:.2f} s (tables included), se_exact on all "
                  f"reads {t2 - t1:.2f} s; peak device memory "
                  f"{peak / 2**30:.2f} GiB; working set {ws:.3f} GiB "
                  f"(peak reserved less {backend.table_bytes() / 2**30:.3f} "
                  f"GiB of tables and {held / 2**30:.3f} GiB held before); "
                  f"graphs {backend.graphs.stats()}")
    backend.free_tables()
    return share, ws


def uniq_build(index: str, device, reps: int = 3):
    """Phase 5, the uniq build alone on the CT00 table: wall time per build
    (synchronized) and the peak allocated memory above the placed table and
    the build's outputs."""
    import torch

    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.index import io_walt
    from walt_tpu_torch.ops import device_index

    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(index)
    g, ht = io_walt.read_table_cached(index + "_CT00", gm)
    dev = device_index.place_table(
        device_index.build_device_table(g, ht, pattern), device)
    secs, over = [], 0
    for _ in range(reps):
        base = start_memory(device)
        t0 = time.perf_counter()
        out = device_index.build_uniq_device(dev["pseq"], dev["index"],
                                             dev["counter"], pattern)
        torch.cuda.synchronize(device)
        secs.append(time.perf_counter() - t0)
        outs = sum(t.numel() * t.element_size() for t in out[:3])
        over = max(over, torch.cuda.max_memory_allocated(device) - base - outs)
        del out
    n = int(ht.index.shape[0])
    say("uniq build", f"{n} entries (CT00): "
                      f"{' / '.join(f'{t:.3f}' for t in secs)} s per build; "
                      f"peak above the placed table and the outputs "
                      f"{over / 2**30:.3f} GiB ({over / n:.2f} B/entry; "
                      f"limit {MAX_UNIQ_BUILD_GIB} GiB)")
    del dev
    torch.cuda.empty_cache()
    if over > MAX_UNIQ_BUILD_GIB * 2**30:
        raise AssertionError(f"the uniq build took {over / 2**30:.3f} GiB "
                             f"above its table and outputs")


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
    from walt_tpu_torch import perf
    from walt_tpu_torch.core.single_end import process_single_end
    from walt_tpu_torch import cli
    from walt_tpu_torch.ops import verify

    work = os.path.dirname(index)
    out = os.path.join(work, "torch.mr")
    argv = ["-i", index, "-r", fastq, "-o", out, "--device", device.type]
    if cli.main(argv) != 0:  # warm-up: kernel load, first allocations
        raise AssertionError("the CLI warm-up run failed")
    perf.reset()
    zero_counts()
    t0 = time.perf_counter()
    with Recorder() as rec:
        if cli.main(argv) != 0:
            raise AssertionError("the timed CLI run failed")
    wall = time.perf_counter() - t0
    launches = counts()
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
    if launches["verify_worklist"] <= 0:
        raise AssertionError("the CLI run never launched the verify kernel")
    say("e2e", f"CLI {n_reads / wall:.1f} reads/s ({wall:.2f} s wall for "
               f"{n_reads} reads, tables included), verify launches "
               f"{launches}; device-resolved share {rec.se_share():.4f}; MR "
               f"and .mapstats byte-identical to the exact host path; host "
               f"stages {stages}")
    return launches, rec.se_share()


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

    from walt_tpu_torch import native
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.ops import verify

    pattern = get_pattern("3")
    top_k, frag_range, b, max_mm = 50, 1000, 5000, 6
    (codes1, lens1), (codes2, lens2) = mates
    lens1, lens2 = lens1.astype(np.int32), lens2.astype(np.int32)
    zero_counts()
    t0 = time.perf_counter()
    s1, fb1 = backend.map_mate_slabs(codes1, lens1, tables[0], False, b,
                                     max_mm, pattern)
    s2, fb2 = backend.map_mate_slabs(codes2, lens2, tables[1], True, b,
                                     max_mm, pattern)
    t1 = time.perf_counter()
    launches = counts()
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
    if launches["verify_worklist"] <= 0:
        raise AssertionError("the PE mapping never launched the verify "
                             "kernel")
    return float(ok.mean()), launches, t1 - t0, t3 - t2


def pe_parity(index: str, pe, device, min_share: float):
    """Phase 7: TorchBackend.map_mate_slabs + native.pe_finalize == the
    exact PE path on every device-resolved pair."""
    import numpy as np
    import torch

    from walt_tpu_torch import perf
    from walt_tpu_torch.host.fastq import FgetsLines, load_batch
    from walt_tpu_torch.index import io_walt
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
    held = start_memory(device)
    reads0 = perf.counters().get("backend.reads", 0)
    share, launches, t_map, t_exact = map_pairs_vs_exact(
        backend, mates, tables, gm.start_index.astype(np.uint32))
    peak = torch.cuda.max_memory_allocated(device)
    ws = working_set(device, held, backend)
    reads = perf.counters().get("backend.reads", 0) - reads0
    if reads != 2 * n:
        raise AssertionError(f"backend.reads {reads} != {2 * n}")
    if share < min_share:
        raise AssertionError(f"device-resolved pair share {share:.4f} < "
                             f"{min_share}")
    say("pe parity", f"{n} pairs: device-resolved pair share {share:.4f}, "
                     f"finalized pairs equal to the exact path on all of "
                     f"them; rungs {backend.rungs}; verify launches "
                     f"{launches}; map_mate_slabs (both mates) {t_map:.2f} s "
                     f"(tables included), exact ranking + join on all pairs "
                     f"{t_exact:.2f} s; peak device memory "
                     f"{peak / 2**30:.2f} GiB; working set {ws:.3f} GiB "
                     f"(peak reserved less {backend.table_bytes() / 2**30:.3f} "
                     f"GiB of tables and {held / 2**30:.3f} GiB held before); "
                     f"graphs {backend.graphs.stats()}")
    backend.free_tables()
    return share, ws


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
    from walt_tpu_torch import perf
    from walt_tpu_torch.core.paired_end import process_paired_end
    from walt_tpu_torch import cli
    from walt_tpu_torch.ops import verify

    work = os.path.dirname(index)
    out = os.path.join(work, "torch_pe.mr")
    argv = ["-i", index, "-1", pe[0], "-2", pe[1], "-o", out,
            "--device", device.type]
    if cli.main(argv) != 0:  # warm-up: kernel load, first allocations
        raise AssertionError("the PE CLI warm-up run failed")
    perf.reset()
    zero_counts()
    t0 = time.perf_counter()
    with Recorder() as rec:
        if cli.main(argv) != 0:
            raise AssertionError("the timed PE CLI run failed")
    wall = time.perf_counter() - t0
    launches = counts()
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
    if launches["verify_worklist"] <= 0:
        raise AssertionError("the PE CLI run never launched the verify "
                             "kernel")
    say("pe e2e", f"CLI {n_pairs / wall:.1f} pairs/s ({wall:.2f} s wall for "
                  f"{n_pairs} pairs, tables included), verify launches "
                  f"{launches}; device-resolved pair share "
                  f"{rec.pe_share():.4f}; MR and .mapstats byte-identical to "
                  f"the exact host path; host stages {stages}")
    return launches, rec.pe_share()


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
    from walt_tpu_torch.host.fastq import FgetsLines, load_batch

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
    real_chunks, real_wait = backend._chunks, backend._wait
    real_step = torch_backend.sharded.map_single_end_sharded

    def chunks(codes, lens, pattern, chunk=None):
        passes.append(dict(reads=codes.shape[0], chunks=0,
                           launches=verify.stage_launches,
                           t0=time.perf_counter()))
        return real_chunks(codes, lens, pattern, chunk)

    def step(*a, **kw):
        passes[-1]["chunks"] += 1
        passes[-1]["slab"] = kw["verify_slab"]
        return real_step(*a, **kw)

    def wait(host):
        out = real_wait(host)
        p = passes[-1]
        p["secs"] = time.perf_counter() - p["t0"]
        p["launches"] = verify.stage_launches - p["launches"]
        return out

    backend._chunks, backend._wait = chunks, wait
    torch_backend.sharded.map_single_end_sharded = step
    try:
        call()
    finally:
        del backend._chunks, backend._wait
        torch_backend.sharded.map_single_end_sharded = real_step
    return "; ".join(
        f"{p['reads']} reads in {p['chunks']} chunks, slab {p['slab']}, "
        f"{p['launches']} launches, {p['secs']:.3f} s" for p in passes)


def mesh_se_parity(index, fastq, mesh, device, n_reads: int,
                   min_share: float):
    """Phase 9 (``device``: the single-device backend's).  Returns (mesh
    backend, single-device backend)."""
    from walt_tpu_torch import native
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.index import io_walt
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
    held = start_memory(device)
    peak_gib(devices, reset=True)
    zero_counts()
    (pos, times, minus, mm, fb), t_mesh = timed(lambda: mesh_b.map_single_end(
        codes, lens, tables, 5000, 6, pattern))
    launches = counts()
    peak = peak_gib(devices)
    s_out, t_single = timed(lambda: single.map_single_end(
        codes, lens, tables, 5000, 6, pattern))

    def steady(b):
        b.reset_adaptive()
        return b.map_single_end(codes, lens, tables, 5000, 6, pattern)

    secs, _ = in_turns({"single": lambda: steady(single),
                        "mesh": lambda: steady(mesh_b)})
    passes = tier_breakdown(mesh_b, lambda: steady(mesh_b))
    ws = working_set(device, held, mesh_b, single)
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
    if launches["verify_worklist"] <= 0:
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
                       f"(mesh tables and working set); working set on "
                       f"{device} {ws:.3f} GiB (both backends' tables and "
                       f"{held / 2**30:.3f} GiB held before excluded); "
                       f"graphs: mesh {mesh_b.graphs.stats()}, single "
                       f"{single.graphs.stats()}; one more steady mesh call "
                       f"by pass: {passes}")
    return mesh_b, single, ws


def mesh_pe_parity(index, pe, mesh_b, single, n_pairs: int,
                   min_share: float):
    """Phase 10."""
    import numpy as np

    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.index import io_walt

    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(index)
    tables = [[io_walt.read_table_cached(index + s, gm) for s in pair]
              for pair in (("_CT00", "_CT01"), ("_GA10", "_GA11"))]
    mates = [load_reads(fq, n_pairs) for fq in pe]
    devices = list(dict.fromkeys(mesh_b.mesh.distinct() + [single.device]))
    held = start_memory(single.device, mesh_b, single)
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
    ws = working_set(single.device, held, mesh_b, single)
    s_fb = np.zeros(n_pairs, bool)
    for (ms, mfb), (ss, sfb) in zip(last["mesh"], last["single"]):
        ok = ~(mfb | sfb)
        for st, sst in zip(ms, ss):
            for k in ("cnt", "seed", "pos", "mm"):
                if (st[k][ok] != sst[k][ok]).any():
                    raise AssertionError(f"mesh PE {k} != single device")
        s_fb |= sfb
    if launches["verify_worklist"] <= 0:
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
                          f"{peak:.2f} GiB; working set {ws:.3f} GiB (both "
                          f"backends' tables and {held / 2**30:.3f} GiB held "
                          f"before excluded); graphs: mesh "
                          f"{mesh_b.graphs.stats()}, single "
                          f"{single.graphs.stats()}")
    single.free_tables()
    return ws


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
    from walt_tpu_torch.core.paired_end import process_paired_end
    from walt_tpu_torch.core.single_end import process_single_end
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
    zero_counts()
    _, wall = timed(lambda: process_single_end(index, se_sub, out,
                                               backend=mesh_b))
    launches = counts()
    same_bytes(out, ref, "mesh SE")
    mesh_b.reset_adaptive()
    zero_counts()
    _, wall_pe = timed(lambda: process_paired_end(
        index, pe_sub[0], pe_sub[1], out_pe, backend=mesh_b))
    launches_pe = counts()
    same_bytes(out_pe, ref_pe, "mesh PE")
    if (launches["verify_worklist"] <= 0
            or launches_pe["verify_worklist"] <= 0):
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


def straddling_filler(index: str) -> int:
    """FILLER, or less when phase 4's first chromosome is too short to
    straddle 2^31 behind it (a multiple of 16 either way)."""
    from walt_tpu_torch.index import io_walt

    first = int(io_walt.read_head(index)[0].lengths[0])
    if FILLER + first > 1 << 31:
        return FILLER
    return ((1 << 31) - first // 2) // 16 * 16


def shifted_index(index: str, F: int):
    """Phase 13's index: phase 4's genome behind a filler chromosome of F
    bases, written once beside phase 4's with ``io_walt``.  The
    reverse-complement genome keeps the chromosome order, so each of the
    four tables is phase 4's with F added to every entry and its counter
    unchanged; the filler is never indexed.  Returns (index path, genome
    length)."""
    import dataclasses

    import numpy as np

    from walt_tpu_torch.genome import Genome
    from walt_tpu_torch.index import io_walt
    from walt_tpu_torch.index.build import HashTable

    gm, size = io_walt.read_head(index)
    lengths = np.concatenate([[F], gm.lengths]).astype(np.uint32)
    start = np.zeros(lengths.shape[0] + 1, np.uint32)
    np.cumsum(lengths, out=start[1:])
    genome = Genome(names=["filler"] + list(gm.names), lengths=lengths,
                    start_index=start, seq=np.zeros(0, np.uint8))
    path = os.path.join(os.path.dirname(index), "shifted.dbindex")
    stamp = f"{path}.{F}.ok"
    if not os.path.exists(stamp):
        for suffix in io_walt.SUFFIXES:
            g, ht = io_walt.read_table_cached(index + suffix, gm)
            seq = np.empty(F + g.seq.shape[0], np.uint8)
            seq[:F] = 0 if g.strand == "+" else 3  # A; T reverse-complemented
            seq[F:] = g.seq
            io_walt.write_table(
                path + suffix, dataclasses.replace(genome, seq=seq,
                                                   strand=g.strand),
                HashTable(counter=ht.counter, index=ht.index + np.uint32(F)))
            del seq
        # the header reads only the genome's length off its sequence
        io_walt.write_head(path, dataclasses.replace(
            genome, seq=np.broadcast_to(np.uint8(0), (int(start[-1]),))),
            size)
        open(stamp, "w").close()
    return path, int(start[-1])


def shifted_phase(index, fastq, pe, se_sub, device, shares, F: int):
    """Phase 13 on the index of :func:`shifted_index` (``shares``: the SE
    and PE device-resolved shares of phases 5 and 7, which phases 6 and 8
    also gave).  Returns (launches of the CLI run, launches of the mesh
    runs)."""
    import torch

    from walt_tpu_torch import cli, hbm_plan
    from walt_tpu_torch.core.single_end import process_single_end
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.parallel import make_mesh

    work = os.path.dirname(index)
    (index_s, n_bp), t_write = timed(lambda: shifted_index(index, F))
    out, out_pe = (os.path.join(work, f)
                   for f in ("shifted.mr", "shifted_pe.mr"))
    zero_counts()
    with Recorder() as rec:
        rc, t_cli = timed(lambda: cli.main(
            ["-i", index_s, "-r", fastq, "-1", pe[0], "-2", pe[1], "-o",
             f"{out},{out_pe}", "--device", device.type]))
    launches = counts()
    if rc != 0:
        raise AssertionError("the shifted CLI run failed")
    same_bytes(out, os.path.join(work, "exact.mr"), "shifted SE CLI")
    same_bytes(out_pe, os.path.join(work, "exact_pe.mr"), "shifted PE CLI")
    got = (rec.se_share(), rec.pe_share())
    top, rungs = rec.max_position(), dict(rec.backend.rungs)
    rec.backend.free_tables()
    del rec
    if got != shares:
        raise AssertionError(f"shifted shares (SE, PE) {got} != {shares}")
    if launches["verify_worklist"] <= 0:
        raise AssertionError("the shifted CLI run never launched the verify "
                             "kernel")

    plan = hbm_plan.plan_tables(n_bp, 2, uniq_ratio=0.93)
    layouts = dict.fromkeys([(plan.tp, "uniq" if plan.uniq else "key16"),
                             (2, "key16")])
    ref = os.path.join(work, "mesh_exact.mr")
    mesh_launches, notes = {}, []
    for tp, accel in layouts:
        rec = Recorder()
        b = rec.watch(TorchBackend(mesh=make_mesh([device] * tp, tp=tp),
                                   tp_accel=accel))
        mo = os.path.join(work, f"shifted_mesh_tp{tp}_{accel}.mr")
        fresh(mo)
        zero_counts()
        _, wall = timed(lambda: process_single_end(index_s, se_sub, mo,
                                                   backend=b))
        c = counts()
        same_bytes(mo, ref, f"shifted mesh tp={tp} {accel}")
        if c["verify_worklist"] <= 0:
            raise AssertionError(f"the shifted mesh tp={tp} {accel} run "
                                 f"never launched the verify kernel")
        for k, v in c.items():
            mesh_launches[k] = mesh_launches.get(k, 0) + v
        top = max(top, rec.max_position())
        notes.append(f"tp={tp} {accel}: share {rec.se_share():.4f}, rungs "
                     f"{b.rungs}, {wall:.2f} s (tables included), launches "
                     f"{c}")
        b.free_tables()
    torch.cuda.empty_cache()
    if top < (1 << 31 if n_bp > 1 << 31 else F):
        raise AssertionError(f"no device result past 2^31 (largest {top})")
    say("shifted", f"{n_bp} positions (filler {F}): index written in "
                   f"{t_write:.1f} s; CLI SE + PE in one run "
                   f"{t_cli:.1f} s (tables included): MR and .mapstats "
                   f"byte-identical to phases 6 and 8, shares SE "
                   f"{got[0]:.4f} PE {got[1]:.4f} (phases 5 and 7: "
                   f"{shares[0]:.4f}, {shares[1]:.4f}), rungs {rungs}, "
                   f"verify launches {launches}; plan {hbm_plan.describe(plan)}; "
                   f"mesh SE on one card, byte-identical to phase 11's exact "
                   f"path: {'; '.join(notes)}; largest position emitted by "
                   f"the device {top} (2^31 = {1 << 31})")
    return launches, mesh_launches


@contextlib.contextmanager
def environ(**env):
    """``os.environ`` with ``env`` set, restored whole afterwards: a
    ``WALTX_HBM_GB`` budget must not reach a later backend."""
    saved = dict(os.environ)
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def ladder_budget_gib(index: str, suffixes, kw_bytes: float) -> float:
    """A ``WALTX_HBM_GB`` for the tables ``suffixes`` of ``index``: their
    base bytes (``TorchBackend.base_bytes``) plus ``kw_bytes`` per entry,
    plus ``HBM_RESERVE``, as tests/test_oom.py sizes its key16 budget.  The backend splits the free budget evenly over the tables not
    yet built (``table_budget_hint``), so each table gets about its base
    and ``kw_bytes`` per entry: 2.5 fits key16 (2 bytes per entry) but not
    u32 word 0 (4) or the uniq runs (~7 or more); 4.5 fits word 0 but not
    uniq on each of four tables (the last one built gets base + 6 per
    entry)."""
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.index import io_walt

    gm, _ = io_walt.read_head(index)
    total = TorchBackend.HBM_RESERVE
    for suffix in suffixes:
        g, ht = io_walt.read_table_cached(index + suffix, gm)
        total += TorchBackend.base_bytes(g, ht) + kw_bytes * ht.index.shape[0]
    return total / 2**30


def knobs_phase(index, se_sub, pe_sub, device):
    """Phase 15: other device shapes and the memory ladder on the card,
    with fresh backends and the environment restored after each run, on
    phase 11's reads and pairs.  SE: chunk 65,536, ``verify_slab_t1`` 16,
    ``_wl1`` 1.25 and a ``WALTX_HBM_GB`` that fits both tables on key16
    only; PE: the mate step's shapes 8 / 2 / 8 (walt_tpu's round-3 shapes,
    set on the backend) and a ``WALTX_HBM_GB`` under which all four tables
    take u32 word 0.  Each run's MR and .mapstats must equal phase 11's
    exact host path, its tables take those rungs by the backend's own
    ladder, and the fused stage is launched (K1 never)."""
    from walt_tpu_torch.core.paired_end import process_paired_end
    from walt_tpu_torch.core.single_end import process_single_end
    from walt_tpu_torch.core.torch_backend import TorchBackend

    work = os.path.dirname(index)
    runs = [
        ("SE", ladder_budget_gib(index, ("_CT00", "_CT01"), 2.5),
         dict(chunk=65536, verify_slab_t1=16), dict(_wl1=1.25), "key16",
         lambda b, out: process_single_end(index, se_sub, out, backend=b),
         "mesh_exact.mr"),
        ("PE", ladder_budget_gib(
            index, ("_CT00", "_CT01", "_GA10", "_GA11"), 4.5), {},
         dict(pe_verify_slab=8, pe_wl=2, pe_flat_factor=8), "u32 word0",
         lambda b, out: process_paired_end(index, pe_sub[0], pe_sub[1], out,
                                           backend=b),
         "mesh_exact_pe.mr"),
    ]
    t0 = time.perf_counter()
    notes = []
    for mode, budget, kw, shapes, rung, process, ref in runs:
        out = os.path.join(work, f"knobs_{mode.lower()}.mr")
        fresh(out)
        with environ(WALTX_HBM_GB=budget):
            rec = Recorder()
            b = rec.watch(TorchBackend(device=device, **kw))
            for name, value in shapes.items():
                setattr(b, name, value)
            wl1 = b._wl1
            zero_counts()
            _, wall = timed(lambda: process(b, out))
            c = counts()
        same_bytes(out, os.path.join(work, ref), f"knobs {mode}")
        rungs = dict(b.rungs)
        share = rec.se_share() if mode == "SE" else rec.pe_share()
        shape = (f"chunk {b.chunk}, slab {b.verify_slab_t1}, wl1 {wl1} "
                 f"({b._wl1} at the end)" if mode == "SE" else
                 f"slab {b.pe_verify_slab}, wl {b.pe_wl}, flat "
                 f"{b.pe_flat_factor}")
        b.free_tables()
        del rec, b
        if set(rungs.values()) != {rung} or len(rungs) != (2 if mode == "SE"
                                                           else 4):
            raise AssertionError(f"knobs {mode}: rungs {rungs}, not {rung} "
                                 f"on every table")
        if c["verify_worklist"] <= 0 or c["verify_windows"] != 0:
            raise AssertionError(f"knobs {mode}: launches {c}: the fused "
                                 f"stage must run, K1 never")
        notes.append(f"{mode} ({shape}, WALTX_HBM_GB "
                     f"{budget:.3f}): rungs {rungs}, share "
                     f"{share:.4f}, launches {c}, {wall:.2f} s (tables "
                     f"included)")
    say("knobs", f"phase 15, byte-identical to phase 11's exact host path, "
                 f"each table's rung by the backend's own ladder, in "
                 f"{time.perf_counter() - t0:.1f} s: " + "; ".join(notes))


#: calls per wall time and profiling window of phase 17
GRAPH_REPS = 5

#: mesh sizes of phase 16 (dp, at tp = 1) and its reps per measurement;
#: it leaves out the tool's end-to-end calls (the mesh's slab tiers, 70-100
#: s of the phase on one H100; phases 9 and 11 map the mesh end to end)
DP_SIZES, DP_REPS = (1, 2, 4), 2


def dp_phase(index: str, device) -> dict:
    """Phase 16: ``tools/dp_scaling_torch.measure`` on phase 4's index,
    one main-path chunk of reads per mesh size.  Returns its launches."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import dp_scaling_torch as dps

    genome, tables = dps.index_genome(index), dps.index_tables(index)
    current = torch.cuda.current_device()
    zero_counts()
    rows, wall = timed(lambda: dps.measure(genome, tables, MAIN_B, device,
                                           sizes=DP_SIZES, reps=DP_REPS,
                                           end_to_end=False))
    c = counts()
    if torch.cuda.current_device() != current:
        raise AssertionError(f"dp: the mesh calls moved the current device "
                             f"from {current} to "
                             f"{torch.cuda.current_device()}")
    notes = []
    for r in rows:
        if "devices" not in r:
            notes.append(f"tp={r['tp']}{' virtual' if r['virtual'] else ''} "
                         f"{r['device_program_s'] * 1e3:.2f} ms")
            continue
        nd, got = r["devices"], r["launches"]
        if not r["results_equal"]:
            raise AssertionError(f"dp={nd}: the dp program's result differs "
                                 f"from its serial chunks'")
        if got != r["serial_launches"] or got["verify_windows"] or \
                got["verify_worklist"] <= 0:
            raise AssertionError(f"dp={nd}: launches {got}, serial chunks "
                                 f"{r['serial_launches']}: the fused stage "
                                 f"must run as often, K1 never")
        eff = (f"implied {r['implied_dp_efficiency']:.3f}" if r["virtual"]
               else f"speedup {r['speedup_vs_1dev']:.3f}, efficiency "
                    f"{r['dp_efficiency']:.3f}")
        notes.append(f"dp={nd}{' virtual' if r['virtual'] else ''} "
                     f"{r['device_program_reads_per_s']:.1f} reads/s "
                     f"({eff}), {got['verify_worklist']} launches")
    if c["verify_worklist"] <= 0 or c["verify_windows"]:
        raise AssertionError(f"dp: launches {c}: the fused stage must run, "
                             f"K1 never")
    say("dp", f"phase 16, {MAIN_B} reads per mesh size, results equal to "
              f"the serial chunks', in {wall:.1f} s: " + "; ".join(notes))
    return c


#: phase 18: the hg19 tool's genome bases, and reads and pairs per read
#: length
HG19_BP, HG19_READS = 32_000_000, 50_000
#: phase 18's entry limit for the plans: 0.4 of a table, so that the limit
#: refuses tp=1 and tp=2 (the runtime's split puts about half of a table on
#: each tp=2 shard) and memory picks the rung at tp=4
HG19_ENTRY_LIMIT = 12_800_000


def hg19_phase() -> tuple:
    """Phase 18: ``tools/hg19_scale_torch.py`` on card 0 at HG19_BP bases,
    its plans under HG19_ENTRY_LIMIT and a memory budget under which the
    SE plan (two tables) splits them tp=4 with the uniq rung and the PE
    plan (four) tp=4 with key16 (a virtual mesh on the one card), both
    read and pair
    lengths, GA10 and GA11 through a spill directory, and the work and
    report in a temporary directory.  Returns (SE launches, PE launches,
    the largest working set in GiB)."""
    import importlib.util
    import tempfile

    import numpy as np

    from walt_tpu_torch import hbm_plan
    from walt_tpu_torch.core.torch_backend import TorchBackend

    spec = importlib.util.spec_from_file_location(
        "hg19_scale_torch", os.path.join(ROOT, "tools", "hg19_scale_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    # the plans read the tables' own split, which holds about a quarter of
    # each table's entries on a tp=4 card: sized on a table whose entries
    # spread evenly over its buckets, the budget lies between the SE uniq
    # and PE key16 cards and the PE uniq card (275, 308 and 549 MB; the
    # tool's genome: 313, 318 and 568), so with tp=1 and tp=2 out of the
    # limit's reach SE takes tp=4 uniq and PE tp=4 key16 (walt_tpu's hg19
    # rung)
    even = [np.linspace(0, HG19_BP, hbm_plan.NB1).astype(np.uint32)]
    lo = max(hbm_plan.card_bytes(HG19_BP, 2, 4, True, 0.93, counters=even * 2),
             hbm_plan.card_bytes(HG19_BP, 4, 4, False, 0.93,
                                 counters=even * 4))
    hi = hbm_plan.card_bytes(HG19_BP, 4, 4, True, 0.93, counters=even * 4)
    hbm_gib = (TorchBackend.HBM_RESERVE + (lo + hi) / 2) / 2**30
    with tempfile.TemporaryDirectory(prefix="hg19_phase_") as tmp:
        report = os.path.join(tmp, "report.json")
        zero_counts()
        with environ(WALTX_HG19_BP=HG19_BP, WALTX_HG19_READS=HG19_READS,
                     WALTX_HG19_DIR=os.path.join(tmp, "work"),
                     WALTX_HG19_REPORT=report):
            rc, wall = timed(lambda: tool.main(
                ["--hbm-gib", f"{hbm_gib:.6f}", "--spill-dir",
                 os.path.join(tmp, "spill"), "--entry-limit",
                 str(HG19_ENTRY_LIMIT)]))
        c = counts()
        with open(report) as f:
            rep = json.load(f)
    mm, cli = rep["mesh_map"], rep["cli_map"]
    pe, cli_pe = rep["mesh_map_pe"], rep["cli_map_pe"]
    if rc != 0 or not all(all(p.values()) for p in rep["parities"].values()):
        raise AssertionError(f"hg19: rc {rc}, parities {rep['parities']}, "
                             f"failures {rep.get('failures')}")
    layout = [(m["tp"], m["virtual"], m["accel"]) for m in (mm, pe)]
    if layout != [(4, True, "uniq"), (4, True, "key16")] or rep["spill"][
            "tables"] != [
            "GA10", "GA11"]:
        raise AssertionError(f"hg19: SE and PE (tp, virtual, accel) "
                             f"{layout}, spilled {rep['spill']['tables']}")
    lengths, pe_lengths = mm["by_length"], pe["by_length"]
    runs = list(lengths.values()) + list(pe_lengths.values()) + [cli, cli_pe]
    se_launches = mm["verify_launches"] + cli["verify_launches"]
    pe_launches = pe["verify_launches"] + cli_pe["verify_launches"]
    if any(v["fallback_pct"] >= 100 for v in lengths.values()) or any(
            v["pair_share"] <= 0 for v in pe_lengths.values()) or any(
            v["verify_launches"] <= 0 or v["degraded_batches"]
            for v in runs) or c["verify_windows"] or \
            c["verify_worklist"] != se_launches + pe_launches:
        raise AssertionError(f"hg19: SE {lengths}, PE {pe_lengths}, CLI "
                             f"{cli} / {cli_pe}, launches {c}: every read "
                             f"and pair set must resolve on the device and "
                             f"launch the fused stage, K1 never, and no "
                             f"batch may go to the host after a device OOM")
    per, per_pe = mm["per_device"], pe["per_device"]
    say("hg19", f"phase 18, tools/hg19_scale_torch.py at {HG19_BP} bp, "
                f"{HG19_READS} reads and pairs per length, in {wall:.1f} s: "
                f"plans {rep['plan']}; {rep['plan_pe']}; tp=4 {mm['accel']} / "
                f"{pe['accel']} virtual meshes, tables placed in "
                f"{mm['setup_s']} s (SE) "
                f"and {pe['setup_s']} s (PE); " + "; ".join(
                    f"{k} bp {v['reads_per_s']} reads/s, fallback "
                    f"{v['fallback_pct']}%, {v['verify_launches']} launches"
                    for k, v in lengths.items())
                + "; " + "; ".join(
                    f"2x{k} bp {v['pairs_per_s']} pairs/s, pair share "
                    f"{v['pair_share']}, {v['verify_launches']} launches"
                    for k, v in pe_lengths.items())
                + f"; CLI (--tp 4, one card) {cli['reads_per_s']} reads/s, "
                f"{cli_pe['pairs_per_s']} pairs/s; per device SE / PE: "
                + "; ".join(
                    f"{d} tables {v['table_gib']} / {per_pe[d]['table_gib']} "
                    f"GiB, working set {v['working_set_gib']} / "
                    f"{per_pe[d]['working_set_gib']} GiB, {v['graphs']} / "
                    f"{per_pe[d]['graphs']} graphs, pools {v['pool_bytes']} "
                    f"/ {per_pe[d]['pool_bytes']} B"
                    for d, v in per.items())
                + f"; peak RSS {rep['peak_rss_gib']} GiB; MR and .mapstats "
                  f"byte-identical to the exact host paths (mesh at 100 and "
                  f"150 bp, CLI; SE and PE); launches SE {se_launches}, PE "
                  f"{pe_launches}, {c}")
    ws = max(v["working_set_gib"] for m in (per, per_pe) for v in m.values())
    return ({"verify_worklist": se_launches,
             "verify_windows": c["verify_windows"]},
            {"verify_worklist": pe_launches,
             "verify_windows": c["verify_windows"]}, ws)


class EagerSteps:
    """``ops/graphs.StepCache``'s interface with every step run eagerly:
    phase 17's reference for a mesh's graph steps (the sharded steps take
    it as ``graphs``)."""

    @staticmethod
    def run(fn, inputs, *args, lane: int = 0, **kw):
        return fn(*inputs, *args, **kw)


def wall_ms(fn, devices, reps: int = GRAPH_REPS):
    """(best, median) wall milliseconds of ``fn()`` to a synchronize of
    every device, ``reps`` calls after a warm one."""
    import statistics

    import torch

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    fn()
    sync()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        secs.append(time.perf_counter() - t0)
    return min(secs) * 1e3, statistics.median(secs) * 1e3


def busy_ms(fn, reps: int = GRAPH_REPS):
    """(device busy ms, device events) per call of ``fn``: the union of the
    device intervals of ``reps`` calls in one torch.profiler window after a
    warm-up call (``ops/stages.profiled``), over ``reps``.  A window that
    holds no device event is profiled again, at most PROFILE_ATTEMPTS
    times."""
    from walt_tpu_torch.ops import stages as st

    trace = os.path.join(ROOT, "build", "graph_trace.json")
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        _, evs = st.profiled(lambda: [fn() for _ in range(reps)], fn, trace)
        os.unlink(trace)
        dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in evs if e.get("cat") in st.DEVICE_CATS]
        if dev:
            return st.union_us(dev) / 1e3 / reps, len(dev) / reps
        say("graphs", f"profiling window {attempt} held no device event; "
                      f"profiling again")
    raise AssertionError(f"no profiling window in {PROFILE_ATTEMPTS} held a "
                         f"device event")


def graph_phase(single, mesh_b, index, fastq, pe) -> None:
    """Phase 17 (right after phase 9, on the CT00 and CT01 tables phase 9's
    backends built): one 131,072-read chunk of phase 4's reads through the
    SE step (tier-1 shape, every seed) and one of its mate-1 reads through
    the PE mate step, on one card and on the mesh, as the backend runs them
    (CUDA graph replays, ``se_step`` / ``mate_step``) and eagerly (one card:
    the step with an ``ops/stages`` recorder; the mesh: its rows' parts run
    by :class:`EagerSteps`).  Each graph step must equal its eager step bit
    for bit, and k replays must count k times the eager step's fused-stage
    launches.  Prints one line: per step the wall ms and device busy ms of
    the graph and of the eager step (``stages=None``), their idle shares,
    and the graphs and pool bytes per device of each backend."""
    import torch

    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.index import io_walt
    from walt_tpu_torch.ops import pe_map, pipeline, se_fold
    from walt_tpu_torch.ops import stages as st
    from walt_tpu_torch.parallel import sharded

    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(index)
    tables = [io_walt.read_table_cached(index + s, gm)
              for s in ("_CT00", "_CT01")]
    reads = {"SE": load_reads(fastq, MAIN_B), "PE": load_reads(pe[0], MAIN_B)}
    t0 = time.perf_counter()
    lines = []
    for where, backend in (("one card", single), ("mesh", mesh_b)):
        mesh = backend.mesh
        n_cached = len(backend._tables)
        built = [backend._device_table(g, ht, pattern, 1) for g, ht in tables]
        if len(backend._tables) != n_cached:
            raise AssertionError(f"phase 17 built a table phase 9 had not "
                                 f"({where})")
        devs = tuple(d for _, d in built)
        devices = mesh.distinct() if mesh is not None else [backend.device]
        for mode in ("SE", "PE"):
            codes, lens = reads[mode]
            _, _, pc, pl = next(backend._chunks(codes, lens, pattern, MAIN_B))
            kw = dict(pattern_name="3", ag_wildcard=False,
                      search_bits=tuple(dt.max_bucket_bits for dt, _ in built),
                      uniq_bits=tuple(dt.uniq_bits for dt, _ in built),
                      exact_b=False, cand_slab=backend.cand_slab,
                      full_mask=TorchBackend._full_mask(lens, pattern))
            if mode == "SE":
                kw.update(verify_slab=pipeline.VERIFY_SLAB_T1, wl_factor=1.5)
                step, body = backend.se_step, se_fold.map_single_end_device
                mesh_body = sharded.map_single_end_sharded
            else:
                kw.update(verify_slab=pe_map.VERIFY_SLAB,
                          wl_factor=pe_map.WL_FACTOR,
                          flat_factor=pe_map.FLAT_FACTOR)
                step, body = backend.mate_step, pe_map.map_mate_device
                mesh_body = sharded.map_mate_sharded

            def graph(step=step, pc=pc, pl=pl, kw=kw):
                out = step(pc, pl, 5000, 6, devs, **kw)
                return tuple(t.clone() for t in
                             (out if isinstance(out, tuple) else (out,)))

            def eager(stages=None, body=body, mesh_body=mesh_body, pc=pc,
                      pl=pl, kw=kw):
                out = (body(pc, pl, 5000, 6, devs, stages=stages, **kw)
                       if mesh is None else
                       mesh_body(pc, pl, 5000, 6, devs, mesh=mesh,
                                 graphs=EagerSteps(), **kw))
                return out if isinstance(out, tuple) else (out,)

            zero_counts()
            want = eager(st.StageLog() if mesh is None else None)
            per_call = counts()
            if per_call["verify_worklist"] <= 0 or per_call["verify_windows"]:
                raise AssertionError(f"{where} {mode}: eager launches "
                                     f"{per_call}")
            got = graph()  # captures the step when phase 9 had not
            reps = 3
            zero_counts()
            for _ in range(reps):
                got = graph()
            launches = counts()
            if launches != {k: reps * v for k, v in per_call.items()}:
                raise AssertionError(f"{where} {mode}: {reps} replays "
                                     f"counted {launches}, the eager step "
                                     f"{per_call} per call")
            if len(got) != len(want) or not all(
                    a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(got, want)):
                raise AssertionError(f"{where} {mode}: the graph step differs "
                                     f"from the eager step")
            g_wall, g_med = wall_ms(graph, devices)
            e_wall, e_med = wall_ms(eager, devices)
            g_busy, g_events = busy_ms(graph)
            e_busy, e_events = busy_ms(eager)
            lines.append(
                f"{where} {mode}: wall graph {g_wall:.3f} ms (median "
                f"{g_med:.3f}), eager {e_wall:.3f} ms ({e_med:.3f}); busy "
                f"{g_busy:.3f} / {e_busy:.3f} ms in {g_events:.0f} / "
                f"{e_events:.0f} device events; idle share "
                f"{1 - g_busy / g_wall:.3f} / {1 - e_busy / e_wall:.3f}; "
                f"{per_call['verify_worklist']} fused launches per call")
        lines.append(f"{where} graphs {backend.graphs.stats()}")
    say("graphs", f"phase 17, one {MAIN_B}-read chunk per step, each graph "
                  f"step bit-identical to its eager step with the same "
                  f"launches per replay, in {time.perf_counter() - t0:.1f} "
                  f"s: " + "; ".join(lines))


#: phase 19, the short-read deployment: pattern 7 on phase 4's genome (SE
#: reads sampled at READ_LEN and trimmed, too-short reads, 2x50 bp pairs),
#: pattern 5 on a genome of its own (SE and 2x100 bp pairs)
P7_READS, P7_SHORT, P7_PAIRS, P7_PAIR_LEN = 500_000, 5_000, 200_000, 50
P5_BP, P5_READS, P5_PAIRS = 32_000_000, 250_000, 100_000
#: phase 19's card-against-CPU check: the first reads of the pattern-7 set
P7_PARITY_READS = 16_384
#: phase 19's graph pool watch: reads per length, and the lengths
WATCH_READS = 20_000
WATCH_LENGTHS = (25, 36, 50, 75, 100, 125, 150)
#: SE length classes of phase 19's shares: too short under pattern 7, hash
#: keys past a 23-24 bp read's end, whole key words, and past
#: key_weight + 48 cared positions (F8: every such read takes the host)
LENGTH_CLASSES = ((15, 22), (23, 37), (38, 117), (118, 150))


def sha256_file(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def pattern_index(fasta: str, index: str, name: str):
    """``python -m walt_tpu_torch.cli index --seed-pattern name`` of
    ``fasta`` into ``index``.  Returns (build seconds, sha256 per file),
    after checking that every table's entries lie inside the genome."""
    from walt_tpu_torch import cli
    from walt_tpu_torch.index import io_walt

    os.makedirs(os.path.dirname(index), exist_ok=True)
    rc, secs = timed(lambda: cli.main(["index", "-c", fasta, "-o", index,
                                       "--seed-pattern", name]))
    if rc != 0:
        raise AssertionError(f"the pattern-{name} index build failed")
    gm, _ = io_walt.read_head(index)
    n_bp = int(gm.start_index[-1])
    for s in io_walt.SUFFIXES:
        _, ht = io_walt.read_table_cached(index + s, gm)
        top = int(ht.index.max(initial=0))
        if top >= n_bp:
            raise AssertionError(f"pattern {name} {s}: entry {top} past the "
                                 f"genome's {n_bp} bases")
    return secs, {s or "head": sha256_file(index + s)
                  for s in ("",) + io_walt.SUFFIXES}


def pattern_outputs(out: str, flags, pe: bool) -> list:
    """The files one run writes (the CLI's ``-a`` / ``-u`` side files)."""
    files = [out, out + ".mapstats"]
    if "-sam" not in flags:
        for m in ("_1", "_2") if pe else ("",):
            files += [f"{out}{m}_unmapped"] if "-u" in flags else []
            files += [f"{out}{m}_ambiguous"] if "-a" in flags else []
    return files


class SetupClock(Recorder):
    """A :class:`Recorder` that also keeps each SE call's read lengths and
    times the backend's table setup (``TorchBackend._device_table``: host
    prep, upload and the device builds) and the time of its first mapping
    call, so a run's wall time splits into setup and mapping."""

    def watch(self, backend):
        import numpy as np

        super().watch(backend)
        self.lens, self.setup_s, self.first = [], 0.0, None
        table, se = backend._device_table, backend.map_single_end
        begin = getattr(backend, "map_mate_slabs_begin", None)

        def timed_table(*a, **k):
            t0 = time.perf_counter()
            try:
                return table(*a, **k)
            finally:
                self.setup_s += time.perf_counter() - t0

        def first(fn):
            def call(*a, **k):
                if self.first is None:
                    self.first = time.perf_counter()
                return fn(*a, **k)
            return call

        def se_call(codes, lens, *a, **k):
            self.lens.append(np.asarray(lens))
            return se(codes, lens, *a, **k)

        backend._device_table = timed_table
        backend.map_single_end = first(se_call)
        if begin is not None:
            backend.map_mate_slabs_begin = first(begin)
        return backend

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self.backend is not None:
            for name in ("_device_table", "map_mate_slabs_begin"):
                self.backend.__dict__.pop(name, None)

    def class_shares(self, classes=LENGTH_CLASSES) -> dict:
        """Device-resolved SE share per read-length class ("-" when the run
        had no read of the class)."""
        import numpy as np

        lens = np.concatenate(self.lens)
        ok = ~np.concatenate([o[4] for o in self.se])
        out = {}
        for lo, hi in classes:
            m = (lens >= lo) & (lens <= hi)
            out[f"{lo}-{hi}"] = round(float(ok[m].mean()), 4) if m.any() \
                else "-"
        return out


def pattern_run(index: str, reads, work: str, tag: str, name: str, flags,
                n: int, device) -> dict:
    """One CLI run on the card under ``--seed-pattern name`` with ``flags``
    against the exact host path with the same flags (``reads``: a FASTQ
    path, or the two of a pair), every output file byte for byte.  Fails
    unless the run launched the fused stage and never K1, mapped no batch
    on the host after a device OOM, and resolved a share above 0."""
    from walt_tpu_torch import cli
    from walt_tpu_torch.core import errors
    from walt_tpu_torch.core.paired_end import process_paired_end
    from walt_tpu_torch.core.single_end import process_single_end

    pe = isinstance(reads, tuple)
    out, ref = (os.path.join(work, f"{tag}{k}.mr") for k in ("", "_exact"))
    argv = ["-i", index, *(["-1", reads[0], "-2", reads[1]] if pe
                           else ["-r", reads]),
            "-o", out, "--seed-pattern", name, "--device", device.type,
            *flags]
    for k in errors.degraded_batches:
        errors.degraded_batches[k] = 0
    zero_counts()
    t0 = time.perf_counter()
    with SetupClock() as rec:
        if cli.main(argv) != 0:
            raise AssertionError(f"phase 19 {tag}: the CLI run failed")
    t1 = time.perf_counter()
    launches, degraded = counts(), dict(errors.degraded_batches)
    share = rec.pe_share() if pe else rec.se_share()
    # wall from the first mapping call, less the tables' device setup
    mapping = t1 - rec.first - rec.setup_s
    classes = None if pe else rec.class_shares()
    graphs = rec.backend.graphs.stats()
    rec.backend.free_tables()
    del rec

    for f in pattern_outputs(ref, flags, pe):
        open(f, "w").close()
    common = dict(pattern_name=name, ambiguous="-a" in flags,
                  unmapped="-u" in flags, sam="-sam" in flags)
    t2 = time.perf_counter()
    if pe:
        process_paired_end(index, reads[0], reads[1], ref,
                           backend=AllFallbackPE(), **common)
    else:
        process_single_end(index, reads, ref, backend=AllFallback(),
                           ag_wildcard="-A" in flags, **common)
    exact_s = time.perf_counter() - t2
    for a, b in zip(pattern_outputs(out, flags, pe),
                    pattern_outputs(ref, flags, pe)):
        with open(a, "rb") as x, open(b, "rb") as y:
            if x.read() != y.read():
                raise AssertionError(f"phase 19 {tag}: {os.path.basename(a)} "
                                     f"differs from the exact host path")
    if launches["verify_worklist"] <= 0 or launches["verify_windows"] or \
            any(degraded.values()) or not share > 0:
        raise AssertionError(f"phase 19 {tag}: launches {launches}, OOM "
                             f"batches {degraded}, share {share}: the fused "
                             f"stage must launch and K1 never, no batch may "
                             f"go to the host after a device OOM, and the "
                             f"device must resolve some "
                             f"{'pairs' if pe else 'reads'}")
    unit = "pairs" if pe else "reads"
    return dict(tag=tag, unit=unit, n=n, share=round(share, 4),
                classes=classes, launches=launches["verify_worklist"],
                wall_s=round(t1 - t0, 2), rate=round(n / (t1 - t0), 1),
                mapping_s=round(mapping, 2),
                rate_mapping=round(n / mapping, 1), exact_s=round(exact_s, 2),
                graphs=graphs)


def pattern_cpu_parity(index: str, fastq: str, device) -> str:
    """The card's ``map_single_end`` arrays == a CPU TorchBackend's on the
    first P7_PARITY_READS pattern-7 reads, element for element."""
    import numpy as np

    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.index import io_walt

    pattern = get_pattern("7")
    gm, _ = io_walt.read_head(index)
    tables = [io_walt.read_table_cached(index + s, gm)
              for s in ("_CT00", "_CT01")]
    codes, lens = load_reads(fastq, P7_PARITY_READS)
    got, secs = [], []
    for dev in (device, "cpu"):
        backend = TorchBackend(device=dev)
        out, t = timed(lambda: backend.map_single_end(codes, lens, tables,
                                                      5000, 6, pattern))
        got.append(out)
        secs.append(t)
        backend.free_tables()
    for name, a, b in zip(("pos", "times", "minus", "mm", "fallback"), *got):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"phase 19: the card's {name} != the CPU "
                                 f"backend's on {int((a != b).sum())} of "
                                 f"{len(lens)} pattern-7 reads")
    return (f"card == CPU TorchBackend on {len(lens)} pattern-7 reads, all "
            f"five arrays (share {float((~got[0][4]).mean()):.4f}; card "
            f"{secs[0]:.1f} s, CPU {secs[1]:.1f} s, tables included)")


def pool_watch(device, genome, indexes: dict) -> tuple:
    """The ROADMAP's graph-pool watch: one backend maps WATCH_READS reads
    of each WATCH_LENGTHS length under pattern 7 and then pattern 3
    (``indexes``: pattern name -> index), printing its graphs and pool
    bytes after each; fails if the working set passes HBM_RESERVE.
    Returns (the largest working set in GiB, fused launches)."""
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.index import io_walt
    from walt_tpu_torch.synth import sample_reads

    reads = {L: sample_reads(genome, WATCH_READS, L, seed=1000 + L)[:2]
             for L in WATCH_LENGTHS}
    backend = TorchBackend(device=device)
    backend.table_budget_hint = 2
    held = start_memory(device)
    reserve = TorchBackend.HBM_RESERVE / 2**30
    zero_counts()
    notes, top = [], 0.0
    for name in ("7", "3"):
        pattern, index = get_pattern(name), indexes[name]
        gm, _ = io_walt.read_head(index)
        tables = [io_walt.read_table_cached(index + s, gm)
                  for s in ("_CT00", "_CT01")]
        for L, (codes, lens) in reads.items():
            fb = backend.map_single_end(codes, lens, tables, 5000, 6,
                                        pattern)[4]
            ws = working_set(device, held, backend)
            top = max(top, ws)
            st = backend.graphs.stats().get(str(device), {})
            notes.append(f"p{name} {L} bp: share {float((~fb).mean()):.4f}, "
                         f"{st.get('graphs', 0)} graphs, pools "
                         f"{st.get('pool_bytes', 0)} B, working set "
                         f"{ws:.3f} GiB")
            if ws > reserve:
                raise AssertionError(f"phase 19 watch: working set "
                                     f"{ws:.3f} GiB > HBM_RESERVE "
                                     f"{reserve:.3f} GiB after {notes[-1]}")
    launches = counts()
    backend.free_tables()
    say("pools", f"phase 19 graph-pool watch, one backend, {WATCH_READS} "
                 f"reads per length, pattern 7 then pattern 3 "
                 f"(HBM_RESERVE {reserve:.3f} GiB): " + "; ".join(notes)
                 + f"; launches {launches}")
    return top, launches


def patterns_phase(device, index3: str) -> dict:
    """Phase 19: seed patterns 5 and 7 on one card (see the module
    docstring).  Returns the fused launches of its runs by name and the
    largest working set."""
    import numpy as np

    from walt_tpu_torch.synth import (
        codes_to_fastq, make_genome_repetitive, sample_pairs, sample_reads,
        write_genome_fasta,
    )

    t_phase = time.perf_counter()
    work = os.path.join(DATA, "patterns")
    os.makedirs(work, exist_ok=True)
    index7 = os.path.join(work, "p7", "smoke.dbindex")
    build7, sha7 = pattern_index(os.path.join(DATA, "genome.fa"), index7, "7")
    say("patterns", f"pattern-7 index of phase 4's {GENOME_BASES} bp genome "
                    f"(python -m walt_tpu_torch.cli index --seed-pattern 7) "
                    f"in {build7:.1f} s, every entry inside the genome; "
                    f"sha256 {sha7}")

    genome = make_genome_repetitive(GENOME_BASES, n_chroms=2, seed=42)
    codes, _, _ = sample_reads(genome, P7_READS, READ_LEN, seed=13)
    tiny, _, _ = sample_reads(genome, P7_SHORT, READ_LEN, seed=23)
    rng = np.random.default_rng(19)
    lens = np.concatenate([rng.integers(23, READ_LEN + 1, P7_READS),
                           rng.integers(15, 23, P7_SHORT)])
    se7 = os.path.join(work, "p7_reads.fq")
    codes_to_fastq(np.concatenate([codes, tiny]), lens, se7)
    del codes, tiny
    c1, l1, c2, l2 = sample_pairs(genome, P7_PAIRS, P7_PAIR_LEN, seed=17,
                                  frag_lo=100, frag_hi=300)
    pe7 = (os.path.join(work, "p7_pairs_1.fq"),
           os.path.join(work, "p7_pairs_2.fq"))
    codes_to_fastq(c1, l1, pe7[0])
    codes_to_fastq(c2, l2, pe7[1])
    del c1, c2

    g5 = make_genome_repetitive(P5_BP, n_chroms=2, seed=43)
    fasta5 = os.path.join(work, "p5_genome.fa")
    write_genome_fasta(g5, fasta5)
    index5 = os.path.join(work, "p5", "smoke.dbindex")
    build5, sha5 = pattern_index(fasta5, index5, "5")
    c, lz, _ = sample_reads(g5, P5_READS, READ_LEN, seed=13)
    se5 = os.path.join(work, "p5_reads.fq")
    codes_to_fastq(c, lz, se5)
    c1, l1, c2, l2 = sample_pairs(g5, P5_PAIRS, READ_LEN, seed=17,
                                  frag_lo=150, frag_hi=500)
    pe5 = (os.path.join(work, "p5_pairs_1.fq"),
           os.path.join(work, "p5_pairs_2.fq"))
    codes_to_fastq(c1, l1, pe5[0])
    codes_to_fastq(c2, l2, pe5[1])
    del c, c1, c2, g5
    t_data = time.perf_counter() - t_phase
    say("patterns", f"pattern-5 index of a {P5_BP} bp genome (seed 43) in "
                    f"{build5:.1f} s, every entry inside the genome, sha256 "
                    f"{sha5}; inputs written, {t_data:.1f} s into the phase")

    n7, n7p = P7_READS + P7_SHORT, P7_PAIRS
    runs = [pattern_run(*args, device) for args in (
        (index7, se7, work, "p7_se_au", "7", ["-a", "-u"], n7),
        (index7, se7, work, "p7_se_Asam", "7", ["-A", "-sam"], n7),
        (index7, pe7, work, "p7_pe", "7", [], n7p),
        (index7, pe7, work, "p7_pe_sam", "7", ["-sam"], n7p),
        (index5, se5, work, "p5_se", "5", [], P5_READS),
        (index5, pe5, work, "p5_pe", "5", [], P5_PAIRS))]
    for r in runs:
        say("patterns", f"{r['tag']}: CLI {r['rate']} {r['unit']}/s "
                        f"({r['wall_s']} s for {r['n']} {r['unit']}, tables "
                        f"included), {r['rate_mapping']} {r['unit']}/s "
                        f"without the table setup ({r['mapping_s']} s); "
                        f"device-resolved "
                        f"{'pair ' if r['unit'] == 'pairs' else ''}share "
                        f"{r['share']}"
                        + (f", by length {r['classes']}" if r['classes'] else
                           "")
                        + f"; fused launches {r['launches']}, K1 0, no OOM "
                          f"batch; exact host path {r['exact_s']} s; every "
                          f"output file byte-identical to it; graphs "
                          f"{r['graphs']}")
    # a too-short read counts once per strand pass, as in the reference
    # (mapping.cpp:230-233 under both table iterations of :491-499)
    with open(os.path.join(work, "p7_se_au.mr.mapstats")) as f:
        too_short = int(f.read().split("too_short:")[1].split()[0])
    if too_short != 2 * P7_SHORT:
        raise AssertionError(f"phase 19: .mapstats too_short {too_short}, "
                             f"want 2 x {P7_SHORT} (the 15-22 bp reads)")
    say("patterns", pattern_cpu_parity(index7, se7, device))
    ws, watch_launches = pool_watch(device, genome, {"7": index7,
                                                     "3": index3})
    say("patterns", f"phase 19 in {time.perf_counter() - t_phase:.1f} s")
    return dict(ws=ws, watch=watch_launches, **{
        r["tag"]: {"verify_worklist": r["launches"], "verify_windows": 0}
        for r in runs})


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
    ptxas = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", f"nvcc {time.perf_counter() - t0:.1f} s "
                 f"{'(up to date)' if not log else ''}{'; '.join(ptxas)}")

    # a genome-sized pseq: 128 Mbp -> 8M packed words
    k1 = check_verify_kernel(device, Wg=GENOME_BASES // 16)
    stage = check_stage_kernel(device, Wg=GENOME_BASES // 16)
    index, fastq, pe = build_data(DATA, GENOME_BASES, N_READS, N_PAIRS,
                                  READ_LEN)
    share, ws_se = backend_parity(index, fastq, device, MIN_DEVICE_SHARE)
    uniq_build(index, device)
    launches, cli_share = end_to_end(index, fastq, device, N_READS)
    pe_share, ws_pe = pe_parity(index, pe, device, MIN_DEVICE_SHARE)
    launches_pe, cli_pe_share = pe_end_to_end(index, pe, device, N_PAIRS)

    mesh, virtual = smoke_mesh()
    say("mesh", f"{mesh} ({'virtual, on one card' if virtual else 'real'}); "
                f"{N_MESH_READS} reads, {N_MESH_PAIRS} pairs")
    se_sub = head_fastq(fastq, os.path.join(DATA, "mesh_reads.fq"),
                        N_MESH_READS)
    pe_sub = tuple(head_fastq(f, os.path.join(DATA, f"mesh_pairs_{i}.fq"),
                              N_MESH_PAIRS) for i, f in enumerate(pe, 1))
    mesh_b, single, ws_mesh = mesh_se_parity(index, se_sub, mesh, device,
                                             N_MESH_READS, MIN_DEVICE_SHARE)
    graph_phase(single, mesh_b, index, fastq, pe)
    ws_mesh_pe = mesh_pe_parity(index, pe_sub, mesh_b, single, N_MESH_PAIRS,
                                MIN_MESH_PE_SHARE)
    launches_mesh, launches_mesh_pe = mesh_end_to_end(
        index, se_sub, pe_sub, mesh_b, virtual, N_MESH_READS, N_MESH_PAIRS)
    del mesh_b, single
    mesh_dryrun()
    if (cli_share, cli_pe_share) != (share, pe_share):
        raise AssertionError(
            f"the CLI shares {cli_share:.4f} / {cli_pe_share:.4f} differ "
            f"from phases 5 and 7's {share:.4f} / {pe_share:.4f}")
    launches_shifted, launches_shifted_mesh = shifted_phase(
        index, fastq, pe, se_sub, device, (share, pe_share),
        straddling_filler(index))
    knobs_phase(index, se_sub, pe_sub, device)
    launches_dp = dp_phase(index, device)
    launches_hg19, launches_hg19_pe, ws_hg19 = hg19_phase()
    patterns = patterns_phase(device, index)

    from walt_tpu_torch.core.torch_backend import TorchBackend

    sets = dict(se=ws_se, pe=ws_pe, mesh_se=ws_mesh, mesh_pe=ws_mesh_pe,
                hg19=ws_hg19, patterns_watch=patterns.pop("ws"))
    reserve = TorchBackend.HBM_RESERVE / 2**30
    say("reserve", f"working sets (peak reserved less resident tables) "
                   f"{', '.join(f'{k} {v:.3f}' for k, v in sets.items())} "
                   f"GiB; TorchBackend.HBM_RESERVE {reserve:.3f} GiB")
    if max(sets.values()) > reserve:
        raise AssertionError("a working set exceeds TorchBackend.HBM_RESERVE")

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "walt_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded {loaded[:5]}")
    runs = dict(launches=launches, launches_pe=launches_pe,
                launches_mesh=launches_mesh,
                launches_mesh_pe=launches_mesh_pe,
                launches_shifted=launches_shifted,
                launches_shifted_mesh=launches_shifted_mesh,
                launches_dp=launches_dp, launches_hg19=launches_hg19,
                launches_hg19_pe=launches_hg19_pe,
                **{f"launches_{k}": v for k, v in patterns.items()})

    def entry(name, source, nums, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "walt_tpu/ops/pallas_verify.py:93",
                **{k: v[name] for k, v in runs.items()}, **nums,
                "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        entry("verify_worklist", "walt_tpu_torch/csrc/verify_stage.cu", stage,
              stage="walt_tpu/ops/pipeline.py:555"),
        entry("verify_windows", "walt_tpu_torch/csrc/verify.cu", k1),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
