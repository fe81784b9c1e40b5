"""hg19-scale proof of walt_tpu_torch on NVIDIA cards: a 3.1 Gbp index
build, the 5-file round trip, and single-end and paired-end mapping parity
on the planned tp mesh.

Port of ``tools/hg19_scale.py``, with the paired-end deployment beside its
single-end one; imports only ``walt_tpu_torch``.  Stages:

0. pre-flight (:func:`preflight`, before anything is written): the disk
   bytes the run will write against ``WALTX_HG19_DISK_GIB``, host memory
   (``MemAvailable``, :func:`host_plan`), free space in the work and spill
   directories, and the planned tp of both deployments (SE: two tables,
   PE: four) against the cards: with fewer cards than tp a virtual mesh
   on the first card is allowed only when every shard fits that card.
   The plans here are from the genome size (a human genome's
   composition); a refused run exits non-zero with the numbers;
1. synthesize a repeat-structured genome (``walt_tpu_torch.synth``, 4
   chromosomes, seed 11), write it as FASTA and load it back as makedb does
   (``load_genome`` with ``GlibcRand(0)``);
2. build all four converted-genome tables with the native counting-sort
   builder and write the WALT 5-file index, one table at a time so host
   memory stays bounded.  With a spill directory the tables the SE stages
   never read (GA10, GA11) are written there and linked into the work
   directory under the index's table names: the readers and the CLI's
   four-file check (walt.cpp:67-85) find them, and the disk holds CT00
   and CT01 alone;
3. round trip: read every table back (into the process's table cache,
   which the mapping stages then use) and hold its arrays to their
   sha256; plan the SE mesh on CT00 and CT01's counters and the PE mesh
   on all four tables' counters;
4. sample bisulfite reads, 100 bp (seed 5) and 150 bp (seed 6), and
   bisulfite read pairs, 2x100 bp (seed 7) and 2x150 bp (seed 8), of
   150-500 bp fragments;
5. map both read sets on the exact host path (``native.se_exact`` for
   every read);
6. map both on the SE plan's tp mesh (its tp and accel; the cards when
   there are as many as tp, else a virtual mesh on the first card) with
   one backend: the tables are placed once (timed apart), then each read
   set is mapped as the backend's graph replays; per card the resident
   table bytes, peak memory, working set and graph pools.  MR and
   .mapstats bytes must equal stage 5's;
7. free the stage-6 tables and run the CLI as a user does (``cli.main_map
   -i -r -o --tp``) on the 100 bp reads: its bytes must equal stage 5's;
8. map both pair sets on the exact host path: ``process_paired_end`` with
   a backend that resolves nothing, so every pair goes through
   ``native.pe_exact_ranked`` and ``pe_join_ranked``;
9. map both on the PE plan's tp mesh as stage 6 does: the four tables
   placed once (timed apart; mate 1 maps C->T on CT00/CT01, mate 2 G->A
   on GA10/GA11), then each pair set as graph replays, with the pair share
   the device resolved (neither mate flagged: slab overflow or flat
   spill).  Bytes must equal stage 8's;
10. free the stage-9 tables and run the CLI (``cli.main_map -i -1 -2 -o
    --tp``, its defaults ``-k 50 -L 1000 -m 6 -b 5000``) on the 2x100 bp
    pairs: its bytes must equal stage 8's.

The drivers answer a device out-of-memory error by mapping the batch on
the host, byte-identical (``core.errors.degraded_batches`` counts it).  A
run whose device stages took that branch, or in which a read or pair set
launched no fused verify stage or resolved nothing on the device, fails:
equal bytes with no device work prove nothing of the cards.  So does a
card whose tables exceed the plan's bytes or whose working set exceeds
``TorchBackend.HBM_RESERVE``.

Past 2^31 positions this exercises what int32 carriers of u32 values must
survive: table entries and chromosome starts >= 2^31 in the fused verify
stage, the uniq build and the result packs, and the per-shard entry limit.

Run on the cards, from the repository root::

    python tools/hg19_scale_torch.py --spill-dir "$(mktemp -d -p /dev/shm)"

Env: WALTX_HG19_BP (genome bases, default 3_100_000_000), WALTX_HG19_READS
(50_000 reads and 50_000 pairs per read length), WALTX_HG19_DIR (work
directory, default <repo>/bench_cache/hg19_torch), WALTX_HG19_REPORT
(default <repo>/HG19SCALE_TORCH.json), WALTX_HG19_SPILL (the spill
directory when ``--spill-dir`` is not given; default none),
WALTX_HG19_DISK_GIB (the bytes the machine may write to disk, default
45).  The genome, tables and read sets are stamped in the work directory,
so a rerun there resumes after them.  The report is written only from a
run on a CUDA card, with the card's name and power limit; ``--device cpu
--hbm-gib G`` rehearses the stages at a small WALTX_HG19_BP and prints the
report instead.  ``--entry-limit N`` plans as if a tp shard could hold
fewer than N entries (default the pipeline's 2^31): at a small genome it
makes the limit, not the memory, decide tp, as it does for hg19 on an
80 GB card.

Disk: each table file holds the converted genome and its u32 entries, 5
bytes per base, so the FASTA and four tables of 3.1 Gbp take ~61 GiB, and
~32 GiB with GA10 and GA11 spilled to a RAM directory (31.91 GiB
written at 3.1 Gbp).  Host memory: see :func:`host_plan`.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

T0 = time.monotonic()
#: the tables the SE stages never read: written to the spill directory
SPILLED = ("GA10", "GA11")
#: (read length, sampling seed, FASTQ name) of the read sets
READ_SETS = ((100, 5, "reads.fastq"), (150, 6, "reads_150.fastq"))
#: (read length, sampling seed, FASTQ name stem) of the pair sets: mate 1
#: in <stem>_1.fastq, mate 2 in <stem>_2.fastq
PAIR_SETS = ((100, 7, "reads"), (150, 8, "reads_150"))
#: -b of every mapping stage (the drivers' and the CLI's default)
B = 5000
#: -k and -L of the PE stages (the CLI's defaults)
TOP_K, FRAG_RANGE = 50, 1000
#: peak host memory of the table builds per genome base: 53.69 GiB at
#: 2.4 Gbp on an 8-core machine (24.0 B per base), 57.15 GiB at 3.1 Gbp on
#: a 32-core one (19.8; both in PERF.md's hg19 table)
HOST_BYTES_PER_BASE = 24
#: peak host memory of the mapping stages per genome base: the table cache
#: holds the four tables (5 B per base each: converted genome, u32
#: entries) and their padded genomes (1 B each), and a table read adds its
#: entries' bytes object (4 B) while it is converted; 84.83 GiB at 3.1 Gbp
#: on a 32-core machine (29.4 B per base; PERF.md's hg19 table)
MAP_BYTES_PER_BASE = 30
#: bytes per read of a FASTQ record past its bases and qualities (name,
#: '+', newlines), and of an MR line past its sequence and qualities
FASTQ_EXTRA, MR_EXTRA = 32, 64


def note(msg: str):
    print(f"[hg19 +{time.monotonic() - T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def peak_rss_gib() -> float:
    """Peak resident host memory of this process so far, GiB (the kernel's
    VmHWM, else getrusage's ru_maxrss)."""
    try:
        with open("/proc/self/status") as f:
            kib = next(int(ln.split()[1]) for ln in f
                       if ln.startswith("VmHWM:"))
    except (OSError, StopIteration):
        import resource

        kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return round(kib / 2**20, 2)


def mem_available() -> int:
    """``MemAvailable`` of /proc/meminfo in bytes (0 when unreadable)."""
    try:
        with open("/proc/meminfo") as f:
            return next(int(ln.split()[1]) * 1024 for ln in f
                        if ln.startswith("MemAvailable:"))
    except (OSError, StopIteration):
        return 0


def free_bytes(path: str) -> int:
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


def tree_bytes(path: str) -> int:
    """Bytes of every file under ``path``, a symbolic link counted as
    itself (its target's bytes were written where the target lies)."""
    return sum(os.lstat(os.path.join(d, f)).st_size
               for d, _, files in os.walk(path) for f in files)


def build_threads(genome_bp: int) -> int:
    """Threads of one table build: every core at hg19 scale, fewer on a
    small genome, where each thread's 64 MB histogram of the 4^12 buckets
    costs more than its share of the sort (one thread per 8 Mi bases)."""
    return max(1, min(os.cpu_count() or 1, genome_bp >> 23))


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(memoryview(np.ascontiguousarray(a)).cast("B"))
    return h.hexdigest()


def table_file_bytes(genome_bp: int) -> int:
    """Upper bound of a WALT table file: strand byte, converted genome, two
    u32 sizes, the CSR counter (4^12 + 1 u32) and one u32 entry per base at
    most (``io_walt.write_table``)."""
    return 1 + genome_bp + 8 + 4 * (4**12 + 1) + 4 * genome_bp


def disk_plan(genome_bp: int, n_reads: int, spill: bool) -> dict:
    """Bytes the run writes: ``work`` to the work directory (FASTA at 70
    bases a line, the four tables or CT00 and CT01 alone with a spill
    directory, the read and pair sets, and the host, mesh and CLI outputs)
    and ``spill`` in the spill directory (GA10 and GA11, kept to the
    end)."""
    fasta = genome_bp + math.ceil(genome_bp / 70) + 4 * 32
    tables = (2 if spill else 4) * table_file_bytes(genome_bp)
    # per set its FASTQs and the host and mesh outputs; the CLI maps the
    # first set once more.  A mapped pair is one MR line of its fragment
    # (at most -L bases), another pair two lines of one mate each
    sets = 0
    for i, (length, _, _) in enumerate(READ_SETS):
        outs = 3 if i == 0 else 2
        sets += n_reads * (2 * length + FASTQ_EXTRA
                           + outs * (2 * length + MR_EXTRA))
        pair_mr = max(2 * FRAG_RANGE + MR_EXTRA,
                      2 * (2 * length + MR_EXTRA))
        sets += n_reads * (2 * (2 * length + FASTQ_EXTRA) + outs * pair_mr)
    return {"work": fasta + tables + sets + 2**20,
            "spill": len(SPILLED) * table_file_bytes(genome_bp)
            if spill else 0}


def host_plan(genome_bp: int, spill: bool) -> dict:
    """Peak host memory in bytes, RAM spill directory included: ``build``
    while the tables are built (:data:`HOST_BYTES_PER_BASE`; GA10 spilled
    while GA11 builds) and ``maps`` in the mapping stages
    (:data:`MAP_BYTES_PER_BASE`; GA10 and GA11 spilled); ``peak`` the
    larger."""
    table = table_file_bytes(genome_bp) if spill else 0
    build = HOST_BYTES_PER_BASE * genome_bp + table
    maps = MAP_BYTES_PER_BASE * genome_bp + len(SPILLED) * table
    return {"build": build, "maps": maps, "peak": max(build, maps)}


def preflight(genome_bp: int, plans, *, n_reads: int, spill: bool,
              disk_limit: int, work_free: int, spill_free: int | None,
              mem_available: int, written: int = 0,
              n_cards: int | None = None,
              card_bytes: int | None = None):
    """Whether a run can finish, from numbers alone: (needs, problems).

    ``plans``: ``hbm_plan.plan_tables`` of the deployments for
    ``genome_bp`` (SE's two tables, PE's four); ``spill``: GA10 and GA11
    go to a spill directory in RAM (``spill_free`` bytes free), not to the
    disk; ``disk_limit``: bytes the machine may write; ``work_free``: free
    bytes in the work directory, which already holds ``written`` bytes of
    an earlier run; ``mem_available``: host memory, which the peak of
    :func:`host_plan` takes; ``n_cards``/``card_bytes``: the CUDA cards
    and one card's memory (None on the CPU, which has no card to check).
    ``problems`` lists each refusal with its numbers; empty means the run
    may start.
    """
    g = 2**30
    disk = disk_plan(genome_bp, n_reads, spill)
    ram = host_plan(genome_bp, spill)
    needs = {"disk_gib": round(disk["work"] / g, 2),
             "spill_gib": round(disk["spill"] / g, 2),
             "host_ram_gib": round(ram["peak"] / g, 2),
             "host_ram_build_gib": round(ram["build"] / g, 2),
             "host_ram_maps_gib": round(ram["maps"] / g, 2)}
    problems = []
    if disk["work"] > disk_limit:
        problems.append(f"the run writes {disk['work'] / g:.2f} GiB to "
                        f"disk, past the {disk_limit / g:.2f} GiB limit")
    if disk["work"] - written > work_free:
        problems.append(f"the work directory needs "
                        f"{(disk['work'] - written) / g:.2f} GiB more, "
                        f"{work_free / g:.2f} GiB free")
    if spill and disk["spill"] > (spill_free or 0):
        problems.append(f"the spill directory needs {disk['spill'] / g:.2f} "
                        f"GiB for {len(SPILLED)} tables, "
                        f"{(spill_free or 0) / g:.2f} GiB free")
    if ram["peak"] > mem_available:
        spilled = f" + {len(SPILLED)} spilled tables" if spill else ""
        problems.append(
            f"host memory: the run needs {ram['peak'] / g:.2f} GiB (builds "
            f"{ram['build'] / g:.2f}: {HOST_BYTES_PER_BASE} B per base"
            f"{' + one spilled table' if spill else ''}; mapping "
            f"{ram['maps'] / g:.2f}: four cached tables, "
            f"{MAP_BYTES_PER_BASE} B per base{spilled}), "
            f"{mem_available / g:.2f} GiB available")
    if n_cards is not None:
        for plan in plans:
            problems += cards_problem(plan, n_cards, card_bytes)
    return needs, problems


def cards_problem(plan, n_cards: int, card_bytes: int) -> list:
    """[] when ``n_cards`` cards of ``card_bytes`` hold ``plan``'s shards:
    one card per shard, or, with fewer cards than tp, every shard on the
    first card (a virtual mesh: the whole tables, the genome words once
    per table) within its memory less the plan's reserve."""
    if n_cards >= plan.tp:
        return []
    g = 2**30
    whole = plan.n_tables * (plan.per_table_base + plan.per_table_accel)
    if whole <= card_bytes - plan.reserve:
        return []
    return [f"the {plan.n_tables}-table plan needs tp={plan.tp} and "
            f"{n_cards} card(s) are visible: the {plan.tp} shards take "
            f"{whole / g:.2f} GiB on one card, past its "
            f"{(card_bytes - plan.reserve) / g:.2f} GiB budget "
            f"({card_bytes / g:.2f} GiB less the {plan.reserve / g:.2f} GiB "
            f"reserve)"]


class HostExactBackend:
    """Every read on the SE driver's fallback lane (``native.se_exact``):
    no device work, the same emission code."""

    name = "host-exact"

    def map_single_end(self, codes, lens, tables, b, max_mm, pat,
                       ag_wildcard=False):
        n = codes.shape[0]
        return (np.zeros(n, np.uint32), np.zeros(n, np.int32),
                np.zeros(n, bool), np.full(n, max_mm, np.int32),
                lens >= pat.min_read_len)


class AllFallbackPE:
    """A PE backend whose mate step resolves nothing: process_paired_end
    maps every pair on the exact host path (native.pe_exact_ranked +
    pe_join_ranked)."""

    cand_slab = 1

    def map_mate_slabs_begin(self, codes, lens, tables, ag_wildcard, b,
                             max_mismatches, pattern):
        return codes.shape[0]

    def map_mate_slabs_finish(self, n):
        return [dict(seed=np.zeros((n, 1), np.int8),
                     pos=np.zeros((n, 1), np.uint32),
                     mm=np.zeros((n, 1), np.int32),
                     cnt=np.zeros(n, np.int32)) for _ in range(2)], \
            np.ones(n, bool)

    def map_mate_slabs(self, *args):
        return self.map_mate_slabs_finish(self.map_mate_slabs_begin(*args))


def fresh(path):
    open(path, "w").close()
    open(path + ".mapstats", "w").close()


def same_bytes(a: str, b: str) -> dict:
    """MR and .mapstats byte equality of two outputs."""
    return {k: open(a + s, "rb").read() == open(b + s, "rb").read()
            for k, s in (("mr_bytes_equal", ""),
                         ("mapstats_bytes_equal", ".mapstats"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--hbm-gib", type=float, default=None,
                    help="device memory the plans assume (default: the "
                         "card's)")
    ap.add_argument("--spill-dir", default=os.environ.get("WALTX_HG19_SPILL"),
                    help="directory in RAM for GA10 and GA11, which are "
                         "linked into the work directory (default: "
                         "WALTX_HG19_SPILL, else none)")
    ap.add_argument("--entry-limit", type=int, default=None,
                    help="entries a tp shard may not reach in the plans "
                         "(default: the pipeline's int32 limit, 2^31)")
    args = ap.parse_args(argv)
    bp = int(os.environ.get("WALTX_HG19_BP", 3_100_000_000))
    n_reads = int(os.environ.get("WALTX_HG19_READS", 50_000))
    work = os.environ.get(
        "WALTX_HG19_DIR", os.path.join(REPO, "bench_cache", "hg19_torch"))
    report = os.environ.get(
        "WALTX_HG19_REPORT", os.path.join(REPO, "HG19SCALE_TORCH.json"))
    disk_limit = int(float(os.environ.get("WALTX_HG19_DISK_GIB", 45)) * 2**30)
    spill = args.spill_dir

    import torch

    from walt_tpu_torch import cli, hbm_plan, native, perf
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.core.errors import degraded_batches
    from walt_tpu_torch.core.paired_end import process_paired_end
    from walt_tpu_torch.core.single_end import process_single_end
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.genome import load_genome
    from walt_tpu_torch.glibc_rand import GlibcRand
    from walt_tpu_torch.index import io_walt
    from walt_tpu_torch.index.build import CONVERSIONS, build_table
    from walt_tpu_torch.ops import verify
    from walt_tpu_torch.parallel import make_mesh
    from walt_tpu_torch.synth import (
        codes_to_fastq, make_genome_repetitive, sample_pairs, sample_reads,
        write_genome_fasta,
    )

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("hg19_scale_torch: no CUDA device is available "
                         "(--device cpu rehearses without one)")
    if not on_card and args.hbm_gib is None:
        raise SystemExit("hg19_scale_torch: --device cpu needs --hbm-gib")
    hbm = (int(args.hbm_gib * 2**30) if args.hbm_gib is not None
           else hbm_plan.device_memory())

    def plan_for(n_tables, counters=None):
        return hbm_plan.plan_tables(bp, n_tables, hbm, uniq_ratio=0.93,
                                    counters=counters,
                                    entry_limit=args.entry_limit)

    rep = {"genome_bp": bp, "n_reads": n_reads, "n_pairs": n_reads}
    if args.entry_limit is not None:
        rep["plan_entry_limit"] = args.entry_limit
    if on_card:
        rep["card"] = {
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], check=True, capture_output=True,
                text=True, timeout=60).stdout.strip().splitlines(),
        }

    # ---- stage 0: pre-flight --------------------------------------------
    os.makedirs(work, exist_ok=True)
    spill_in_ram = False
    if spill:
        os.makedirs(spill, exist_ok=True)
        # a spill directory on the work directory's file system is disk
        spill_in_ram = os.stat(spill).st_dev != os.stat(work).st_dev

    def written() -> int:
        """Bytes on the disk: the work directory's, and the spill
        directory's when it is on the disk too."""
        return tree_bytes(work) + (tree_bytes(spill) if spill
                                   and not spill_in_ram else 0)

    peaks = rep["peak_rss_gib_by_stage"] = {}
    ends = rep["elapsed_s_by_stage"] = {}

    def save(stage: str):
        peaks[stage] = rep["peak_rss_gib"] = peak_rss_gib()
        rep["disk_written_bytes"] = written()
        rep["disk_written_gib"] = round(rep["disk_written_bytes"] / 2**30, 2)
        ends[stage] = rep["elapsed_s"] = round(time.monotonic() - T0, 1)
        if on_card:
            with open(report, "w") as f:
                json.dump(rep, f, indent=1)

    plans0 = [plan_for(2), plan_for(4)]
    n_cards = torch.cuda.device_count() if on_card else None
    card_mem = hbm_plan.device_memory() if on_card else None
    needs, problems = preflight(
        bp, plans0, n_reads=n_reads, spill=spill_in_ram,
        disk_limit=disk_limit, work_free=free_bytes(work),
        spill_free=free_bytes(spill) if spill else None,
        mem_available=mem_available(), written=written(),
        n_cards=n_cards, card_bytes=card_mem)
    rep["preflight"] = dict(needs, plan=hbm_plan.describe(plans0[0]),
                            plan_pe=hbm_plan.describe(plans0[1]),
                            cards=n_cards, spill_dir=spill)
    for p in problems:
        note(f"pre-flight: {p}")
    if problems:
        note(f"refused before stage 1: {rep['preflight']}")
        return 2
    note(f"pre-flight: {rep['preflight']}")

    pattern = get_pattern("3")
    fasta = os.path.join(work, "genome.fa")
    index = os.path.join(work, "hg19s.dbindex")
    meta_path = os.path.join(work, "build_meta.json")

    # ---- stage 1: genome ------------------------------------------------
    if not os.path.exists(fasta + ".ok"):
        note(f"generating a {bp / 1e9:.2f} Gbp repeat-structured genome")
        t = time.time()
        g = make_genome_repetitive(bp, n_chroms=4, seed=11)
        write_genome_fasta(g, fasta)
        del g
        gc.collect()
        rep["datagen_s"] = round(time.time() - t, 1)
        open(fasta + ".ok", "w").close()
        save("genome")
    note("loading the genome from FASTA (makedb's path, GlibcRand(0))")
    t = time.time()
    genome = load_genome([fasta], GlibcRand(0))
    rep["fasta_load_s"] = round(time.time() - t, 1)
    if genome.length_of_genome != bp:
        raise AssertionError(f"genome of {genome.length_of_genome} bases, "
                             f"not {bp}")
    rep["max_position"] = int(genome.start_index[-1]) - 1
    rep["positions_beyond_int32"] = rep["max_position"] >= 2**31

    # ---- stage 2: build + write the 4 tables, one at a time -------------
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}
    for conv in CONVERSIONS:
        if conv in meta:
            continue
        spilled = bool(spill) and conv in SPILLED
        name = os.path.basename(index) + "_" + conv
        path = os.path.join(spill if spilled else work, name)
        note(f"building table {conv} (native counting-sort CSR) -> "
             f"{'spill' if spilled else 'work'} directory")
        t = time.time()
        g, ht = build_table(genome, conv, pattern, verbose=False,
                            sort_threads=build_threads(bp))
        build_s = time.time() - t
        t = time.time()
        io_walt.write_table(path, g, ht)
        write_s = time.time() - t
        if spilled:
            # the index's table name in the work directory points at it
            link = os.path.join(work, name)
            if os.path.lexists(link):
                os.remove(link)
            os.symlink(os.path.abspath(path), link)
        meta[conv] = {
            "build_s": round(build_s, 1),
            "write_s": round(write_s, 1),
            "entries": int(ht.index_size),
            "max_bucket": int(np.diff(ht.counter.astype(np.int64)).max()),
            "sha256": sha(ht.counter, ht.index),
            "file_bytes": os.path.getsize(path),
            "dir": "spill" if spilled else "work",
        }
        if spilled:
            meta[conv]["spill_bytes"] = tree_bytes(spill)
        del g, ht
        gc.collect()
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        note(f"{conv} done in {build_s:.0f} s build + {write_s:.0f} s write "
             f"(peak rss {peak_rss_gib()} GiB)")
    if not os.path.exists(index):
        io_walt.write_head(index, genome,
                           max(m["entries"] for m in meta.values()))
    rep["tables"] = meta
    rep["index_build_s_total"] = round(
        sum(m["build_s"] + m["write_s"] for m in meta.values()), 1)
    rep["index_disk_gb"] = round(
        sum(m["file_bytes"] for m in meta.values()
            if m["dir"] == "work") / 2**30, 2)
    spilled = [c for c in CONVERSIONS if meta[c]["dir"] == "spill"]
    rep["spill"] = {"dir": spill, "tables": spilled,
                    "links": sorted(os.path.basename(index) + "_" + c
                                    for c in spilled),
                    "peak_gib": round(max([m.get("spill_bytes", 0)
                                           for m in meta.values()])
                                      / 2**30, 2)}
    save("builds")

    # ---- stage 3: 5-file round trip, the plans --------------------------
    note("round trip: header")
    gm, size_of_index = io_walt.read_head(index)
    if gm.names != genome.names or not np.array_equal(gm.lengths,
                                                      genome.lengths):
        raise AssertionError("round trip: header differs")
    if size_of_index != max(m["entries"] for m in meta.values()):
        raise AssertionError("round trip: size_of_index differs")
    rt, counters = {}, []
    for conv in CONVERSIONS:
        note(f"round trip: {conv} (into the table cache)")
        t = time.time()
        _, ht = io_walt.read_table_cached(index + "_" + conv, gm)
        if sha(ht.counter, ht.index) != meta[conv]["sha256"]:
            raise AssertionError(f"round trip: {conv} differs")
        rt[conv] = {"read_s": round(time.time() - t, 1), "sha_ok": True}
        counters.append(ht.counter)
        del ht
    rep["round_trip"] = rt
    # the plans read the runtime's own split of the tables (bucket ranges
    # of about equal entry counts)
    plan, plan_pe = plan_for(2, counters[:2]), plan_for(4, counters)
    rep["plan"] = hbm_plan.describe(plan)
    rep["plan_pe"] = hbm_plan.describe(plan_pe)
    rep["heaviest_shard_entries"] = hbm_plan.heaviest_shard(
        bp, plan.tp, counters[:2])
    rep["heaviest_shard_entries_pe"] = hbm_plan.heaviest_shard(
        bp, plan_pe.tp, counters)
    rep["card_shares_pe"] = np.round(hbm_plan.card_shares(
        plan_pe.tp, 4, counters), 4).tolist()
    del counters
    save("round_trip")
    # the tables' own split may need more cards than the pre-flight's plans
    for p in ([q for pl in (plan, plan_pe)
               for q in cards_problem(pl, n_cards, card_mem)]
              if on_card else []):
        note(f"refused at stage 3: {p}")
        return 2

    # ---- stage 4: reads and pairs ---------------------------------------
    fqs, pairs = {}, {}
    for length, seed, name in READ_SETS:
        fq = fqs[length] = os.path.join(work, name)
        if not os.path.exists(fq + ".ok"):
            note(f"sampling {n_reads} x {length} bp bisulfite reads")
            codes, lens, _ = sample_reads(genome, n_reads, length, seed=seed)
            codes_to_fastq(codes, lens, fq)
            open(fq + ".ok", "w").close()
            del codes, lens
    for length, seed, stem in PAIR_SETS:
        fq1, fq2 = pairs[length] = tuple(
            os.path.join(work, f"{stem}_{m}.fastq") for m in (1, 2))
        if not os.path.exists(fq1 + ".ok"):
            note(f"sampling {n_reads} x 2x{length} bp bisulfite read pairs")
            c1, l1, c2, l2 = sample_pairs(genome, n_reads, length, seed=seed)
            codes_to_fastq(c1, l1, fq1)
            codes_to_fastq(c2, l2, fq2)
            open(fq1 + ".ok", "w").close()
            del c1, c2
    del genome
    gc.collect()

    if native.get_lib() is None:
        raise RuntimeError("the native library is required")

    def out_path(kind, length):
        return os.path.join(
            work, f"out_{kind}{'' if length == 100 else f'_{length}'}.mr")

    def planned_mesh(p):
        """(mesh, virtual) of plan ``p``: its tp over the first cards when
        there are as many, else a virtual mesh on the first card."""
        if on_card:
            devices = ([torch.device("cuda", i) for i in range(p.tp)]
                       if n_cards >= p.tp else [torch.device("cuda", 0)]
                       * p.tp)
        else:
            devices = [torch.device("cpu")] * p.tp
        return make_mesh(devices, tp=p.tp), len(set(devices)) < len(devices)

    def sync(devices):
        if on_card:
            for d in devices:
                torch.cuda.synchronize(d)

    def start_devices(devices) -> dict:
        """Release what earlier stages left and reset the peaks; returns
        the bytes each card still holds."""
        if not on_card:
            return {}
        gc.collect()
        sync(devices)
        torch.cuda.empty_cache()
        held = {d: torch.cuda.memory_allocated(d) for d in devices}
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
        return held

    def place(backend, convs, devices) -> float:
        """Seconds to place ``convs`` on ``backend``'s mesh, from the
        table cache the drivers read (the same objects, so placed once)."""
        t = time.time()
        for conv in convs:
            g, ht = io_walt.read_table_cached(index + "_" + conv, gm)
            backend._device_table(g, ht, pattern, backend._needed_key_words(B),
                                  ag_wildcard=conv.startswith("GA"))
        sync(devices)
        return time.time() - t

    def per_card(backend, devices, held) -> dict:
        """Per card: resident tables, peak memory, working set (peak
        reserved less the tables and what earlier stages held) and the
        graphs with their pools' bytes."""
        pools = backend.graphs.stats()
        per = {}
        for d in devices:
            tables = backend.table_bytes(d)
            reserved = torch.cuda.max_memory_reserved(d) - held[d]
            per[str(d)] = {
                "table_gib": round(tables / 2**30, 2),
                "peak_allocated_gib": round(
                    torch.cuda.max_memory_allocated(d) / 2**30, 2),
                "peak_reserved_gib": round(
                    torch.cuda.max_memory_reserved(d) / 2**30, 2),
                "working_set_gib": round((reserved - tables) / 2**30, 3),
                **pools.get(str(d), {"graphs": 0, "pool_bytes": 0}),
            }
        return per

    def mesh_record(p, mesh, virtual, backend, setup_s) -> dict:
        return {"tp": p.tp, "dp": 1, "accel": backend.tp_accel,
                "virtual": virtual,
                "devices": [str(d) for d in mesh.distinct()],
                "rungs": dict(backend.rungs), "setup_s": round(setup_s, 1),
                "plan_card_gib": round(p.per_chip_bytes / 2**30, 2),
                "by_length": {}}

    def card_records(into, backend, devices, held):
        if not on_card:
            return
        into["per_device"] = per_card(backend, devices, held)
        into["hbm_reserve_gib"] = TorchBackend.HBM_RESERVE / 2**30
        into["peak_device_gib"] = max(
            v["peak_allocated_gib"] for v in into["per_device"].values())

    parities = rep["parities"] = {}

    def run_cli(argv, devices):
        """(rc, seconds, fused-stage launches, degraded batches) of one CLI
        run in this process."""
        launches0, deg0 = verify.stage_launches, dict(degraded_batches)
        t = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            rc = cli.main_map(argv + ([] if on_card else ["--device", "cpu"]))
        sync(devices)
        return (rc, time.time() - t, verify.stage_launches - launches0,
                sum(degraded_batches.values()) - sum(deg0.values()))

    # ---- stage 5: SE on the exact host path -----------------------------
    rep["host_map"] = {}
    for length, fq in fqs.items():
        out = out_path("host", length)
        note(f"mapping {length} bp on the exact host path (native se_exact)")
        fresh(out)
        t = time.time()
        stat = process_single_end(index, fq, out, batch_size=n_reads, b=B,
                                  max_mismatches=6,
                                  backend=HostExactBackend())
        host_s = time.time() - t
        rep["host_map"][str(length)] = {
            "seconds": round(host_s, 1),
            "reads_per_s": round(n_reads / host_s, 1),
            "unique": int(stat.unique), "ambiguous": int(stat.ambiguous),
            "unmapped": int(stat.unmapped),
        }
    save("se_host")

    # ---- stage 6: SE on the planned tp mesh -----------------------------
    accel = "uniq" if plan.uniq else "key16"
    mesh, virtual = planned_mesh(plan)
    distinct = mesh.distinct()
    note(f"mapping on {mesh} ({'virtual' if virtual else 'real'}), {accel} "
         f"shards, per the plan: {rep['plan']}")
    held = start_devices(distinct)
    backend = TorchBackend(mesh=mesh, tp_accel=accel)
    # the tables process_single_end maps on
    setup_s = place(backend, ("CT00", "CT01"), distinct)
    mesh_map = rep["mesh_map"] = mesh_record(plan, mesh, virtual, backend,
                                             setup_s)
    def read_counts():
        got = perf.counters()
        return (got.get("backend.fallback_reads", 0),
                got.get("backend.reads", 0))

    fb_all, n_all = read_counts()
    for length, fq in fqs.items():
        out = out_path("mesh", length)
        fresh(out)
        launches0, deg0 = verify.stage_launches, degraded_batches["se"]
        fb0, n0 = read_counts()
        t = time.time()
        stat = process_single_end(index, fq, out, batch_size=n_reads, b=B,
                                  max_mismatches=6, backend=backend)
        sync(distinct)
        mesh_s = time.time() - t
        fb1, n1 = read_counts()
        mesh_map["by_length"][str(length)] = {
            "seconds": round(mesh_s, 1),
            "reads_per_s": round(n_reads / mesh_s, 1),
            "fallback_pct": round(100 * (fb1 - fb0) / max(1, n1 - n0), 3),
            "unique": int(stat.unique),
            "verify_launches": verify.stage_launches - launches0,
            "degraded_batches": degraded_batches["se"] - deg0,
        }
        parities[f"mesh_{length}"] = same_bytes(out_path("host", length),
                                                out)
        note(f"mesh {length} bp: {mesh_map['by_length'][str(length)]}, "
             f"parity {parities[f'mesh_{length}']}")
    fb1, n1 = read_counts()
    mesh_map["fallback_pct"] = round(
        100 * (fb1 - fb_all) / max(1, n1 - n_all), 3)
    mesh_map["verify_launches"] = sum(
        v["verify_launches"] for v in mesh_map["by_length"].values())
    card_records(mesh_map, backend, distinct, held)
    backend.free_tables()
    del backend
    save("se_mesh")

    # ---- stage 7: the SE CLI as users run it ----------------------------
    out_cli = out_path("cli", 100)
    argv = ["-i", index, "-r", fqs[100], "-o", out_cli, "--tp", str(plan.tp)]
    note(f"the CLI: waltx {' '.join(argv)}")
    start_devices(distinct)
    rc, cli_s, launches, degraded = run_cli(argv, distinct)
    rep["cli_map"] = {
        "flags": argv[6:], "rc": rc, "seconds": round(cli_s, 1),
        "reads_per_s": round(n_reads / cli_s, 1), "cards": n_cards,
        "verify_launches": launches, "degraded_batches": degraded,
    }
    parities["cli_100"] = same_bytes(out_path("host", 100), out_cli)
    save("se_cli")

    # ---- stage 8: PE on the exact host path -----------------------------
    rep["host_map_pe"] = {}
    for length, (fq1, fq2) in pairs.items():
        out = out_path("host_pe", length)
        note(f"mapping 2x{length} bp pairs on the exact host path "
             f"(native pe_exact_ranked + pe_join_ranked)")
        fresh(out)
        t = time.time()
        stat = process_paired_end(index, fq1, fq2, out, batch_size=n_reads,
                                  b=B, max_mismatches=6, top_k=TOP_K,
                                  frag_range=FRAG_RANGE,
                                  backend=AllFallbackPE())
        host_s = time.time() - t
        rep["host_map_pe"][str(length)] = {
            "seconds": round(host_s, 1),
            "pairs_per_s": round(n_reads / host_s, 1),
            "unique": int(stat.unique_pairs),
            "ambiguous": int(stat.ambiguous_pairs),
            "unmapped": int(stat.unmapped_pairs),
        }
    save("pe_host")

    # ---- stage 9: PE on the planned tp mesh -----------------------------
    accel_pe = "uniq" if plan_pe.uniq else "key16"
    mesh_pe, virtual_pe = planned_mesh(plan_pe)
    distinct_pe = mesh_pe.distinct()
    note(f"mapping pairs on {mesh_pe} "
         f"({'virtual' if virtual_pe else 'real'}), {accel_pe} shards, per "
         f"the plan: {rep['plan_pe']}")
    held = start_devices(distinct_pe)

    class Recording(TorchBackend):
        """The backend, keeping each mate step's fallback mask: a pair
        resolves on the device when neither mate falls back."""

        def map_mate_slabs_finish(self, handle):
            streams, fallback = super().map_mate_slabs_finish(handle)
            self.mate_fallback.append(fallback)
            return streams, fallback

    backend = Recording(mesh=mesh_pe, tp_accel=accel_pe)
    setup_s = place(backend, CONVERSIONS, distinct_pe)
    mesh_pe_map = rep["mesh_map_pe"] = mesh_record(
        plan_pe, mesh_pe, virtual_pe, backend, setup_s)
    for length, (fq1, fq2) in pairs.items():
        out = out_path("mesh_pe", length)
        fresh(out)
        launches0, deg0 = verify.stage_launches, degraded_batches["pe"]
        backend.mate_fallback = []
        t = time.time()
        stat = process_paired_end(index, fq1, fq2, out, batch_size=n_reads,
                                  b=B, max_mismatches=6, top_k=TOP_K,
                                  frag_range=FRAG_RANGE, backend=backend)
        sync(distinct_pe)
        mesh_s = time.time() - t
        # the driver finishes mate 1, then mate 2, of each batch
        fb = backend.mate_fallback
        mates = [np.concatenate(fb[m::2]) if fb else np.zeros(0, bool)
                 for m in (0, 1)]
        either = (mates[0] | mates[1]) if fb else np.ones(n_reads, bool)
        mesh_pe_map["by_length"][str(length)] = {
            "seconds": round(mesh_s, 1),
            "pairs_per_s": round(n_reads / mesh_s, 1),
            "pair_share": round(float((~either).mean()), 4),
            "fallback_pairs": int(either.sum()),
            "mate_fallback_pct": [round(100 * float(m.mean()), 3)
                                  if m.size else 100.0 for m in mates],
            "unique": int(stat.unique_pairs),
            "verify_launches": verify.stage_launches - launches0,
            "degraded_batches": degraded_batches["pe"] - deg0,
        }
        parities[f"mesh_pe_{length}"] = same_bytes(
            out_path("host_pe", length), out)
        note(f"mesh PE 2x{length} bp: "
             f"{mesh_pe_map['by_length'][str(length)]}, parity "
             f"{parities[f'mesh_pe_{length}']}")
    mesh_pe_map["verify_launches"] = sum(
        v["verify_launches"] for v in mesh_pe_map["by_length"].values())
    card_records(mesh_pe_map, backend, distinct_pe, held)
    backend.free_tables()
    del backend
    save("pe_mesh")

    # ---- stage 10: the PE CLI as users run it ---------------------------
    out_cli_pe = out_path("cli_pe", 100)
    argv = ["-i", index, "-1", pairs[100][0], "-2", pairs[100][1], "-o",
            out_cli_pe, "--tp", str(plan_pe.tp)]
    note(f"the CLI: waltx {' '.join(argv)}")
    start_devices(distinct_pe)
    rc_pe, cli_s, launches, degraded = run_cli(argv, distinct_pe)
    rep["cli_map_pe"] = {
        "flags": argv[8:], "rc": rc_pe, "seconds": round(cli_s, 1),
        "pairs_per_s": round(n_reads / cli_s, 1), "cards": n_cards,
        "verify_launches": launches, "degraded_batches": degraded,
    }
    parities["cli_pe_100"] = same_bytes(out_path("host_pe", 100), out_cli_pe)

    # ---- parity and the device's share of the work ----------------------
    same = {k: all(p[k] for p in parities.values())
            for k in ("mr_bytes_equal", "mapstats_bytes_equal")}
    rep["parity"] = same
    rep["entry_limit_checked"] = True  # check_entry_limit ran per shard
    rep["k1_launches"] = verify.launches
    rep["spill"]["end_gib"] = round(tree_bytes(spill) / 2**30, 2) \
        if spill else 0.0
    failures = []
    if rc or rc_pe:
        failures.append(f"CLI exit codes {rc} (SE), {rc_pe} (PE)")
    if not all(same.values()):
        failures.append(f"parities {parities}")
    # a device out-of-memory error maps the batch on the host,
    # byte-identical: the mesh must have done the work
    runs = {f"mesh SE {k} bp": (v, 100 - v["fallback_pct"])
            for k, v in mesh_map["by_length"].items()}
    runs.update({f"mesh PE 2x{k} bp": (v, v["pair_share"])
                 for k, v in mesh_pe_map["by_length"].items()})
    runs["CLI SE"] = (rep["cli_map"], None)
    runs["CLI PE"] = (rep["cli_map_pe"], None)
    for what, (v, share) in runs.items():
        if v["degraded_batches"]:
            failures.append(f"{what}: {v['degraded_batches']} batch(es) "
                            f"mapped on the host after a device OOM")
        if share is not None and share <= 0:
            failures.append(f"{what}: nothing resolved on the device")
        if on_card and v["verify_launches"] <= 0:
            failures.append(f"{what}: no fused verify stage launched")
    if on_card and verify.launches:
        failures.append(f"K1 launched {verify.launches} times")
    for what, m, p in (("SE", mesh_map, plan), ("PE", mesh_pe_map, plan_pe)):
        for d, v in m.get("per_device", {}).items():
            if not m["virtual"] and v["table_gib"] > m["plan_card_gib"]:
                failures.append(f"{what} {d}: {v['table_gib']} GiB of "
                                f"tables, past the plan's "
                                f"{m['plan_card_gib']} GiB")
            if v["working_set_gib"] > m["hbm_reserve_gib"]:
                failures.append(f"{what} {d}: working set "
                                f"{v['working_set_gib']} GiB past "
                                f"HBM_RESERVE")
    rep["failures"] = failures
    save("pe_cli")
    note(f"parity: {parities}; SE fallback {mesh_map['fallback_pct']}%, "
         f"PE pair shares "
         f"{[v['pair_share'] for v in mesh_pe_map['by_length'].values()]}, "
         f"verify launches {mesh_map['verify_launches']} (SE mesh), "
         f"{mesh_pe_map['verify_launches']} (PE mesh)")
    if not on_card:
        print(json.dumps(rep, indent=1))
    for f in failures:
        note(f"failed: {f}")
    if failures:
        return 1
    note("hg19-scale proof complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
