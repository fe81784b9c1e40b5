"""hg19-scale proof of walt_tpu_torch on NVIDIA cards: a 3.1 Gbp index
build, the 5-file round trip, and mapping parity on the planned tp mesh.

Port of ``tools/hg19_scale.py``; imports only ``walt_tpu_torch``.  Stages:

0. pre-flight (:func:`preflight`, before anything is written): the disk
   bytes the run will write against ``WALTX_HG19_DISK_GIB``, host memory
   (``MemAvailable``), free space in the work and spill directories, and
   the planned tp against the cards: with fewer cards than tp a virtual
   mesh on the first card is allowed only when every shard fits that
   card.  The plan here is from the genome size (a human genome's
   composition); a refused run exits non-zero with the numbers;
1. synthesize a repeat-structured genome (``walt_tpu_torch.synth``, 4
   chromosomes, seed 11), write it as FASTA and load it back as makedb does
   (``load_genome`` with ``GlibcRand(0)``);
2. build all four converted-genome tables with the native counting-sort
   builder and write the WALT 5-file index, one table at a time so host
   memory stays bounded.  With a spill directory the tables the SE stages
   never read (GA10, GA11) are written there, read back, held to their
   sha256 and removed before the next table is built;
3. round trip: read every table still in the work directory back and hold
   its arrays to their sha256; plan the mesh on the SE tables' counters;
4. sample bisulfite reads: 100 bp (seed 5) and 150 bp (seed 6);
5. map both read sets on the exact host path (``native.se_exact`` for
   every read);
6. map both on the tp mesh that ``walt_tpu_torch.hbm_plan`` plans for these
   tables on this card (its tp and accel; the cards when there are as many
   as tp, else a virtual mesh on the first card) with one backend: the
   tables are placed once (timed apart), then each read set is mapped as
   the backend's graph replays; per card the resident table bytes, peak
   memory, working set and graph pools.  MR and .mapstats bytes must equal
   stage 5's;
7. free the stage-6 tables and run the CLI as a user does (``cli.main_map
   -i -r -o --tp``) on the 100 bp reads: its bytes must equal stage 5's.
   The CLI checks that all four table files exist (walt.cpp:67-85); SE
   reads only CT00 and CT01, so spilled tables stand in as empty files
   while it runs.

Past 2^31 positions this exercises what int32 carriers of u32 values must
survive: table entries and chromosome starts >= 2^31 in the fused verify
stage, the uniq build and the result packs, and the per-shard entry limit.

Run on the cards, from the repository root::

    python tools/hg19_scale_torch.py --spill-dir "$(mktemp -d -p /dev/shm)"

Env: WALTX_HG19_BP (genome bases, default 3_100_000_000), WALTX_HG19_READS
(50_000 per read length), WALTX_HG19_DIR (work directory, default
<repo>/bench_cache/hg19_torch), WALTX_HG19_REPORT (default
<repo>/HG19SCALE_TORCH.json), WALTX_HG19_SPILL (the spill directory when
``--spill-dir`` is not given; default none), WALTX_HG19_DISK_GIB (the
bytes the machine may write to disk, default 45).  Stages are stamped in
the work directory, so a rerun there resumes after the last completed
one.  The report is written only from a run on a CUDA card, with the
card's name and power limit; ``--device cpu --hbm-gib G`` rehearses the
stages at a small WALTX_HG19_BP and prints the report instead.

Disk: each table file holds the converted genome and its u32 entries, 5
bytes per base, so the FASTA and four tables of 3.1 Gbp take ~61 GiB, and
~32 GiB with GA10 and GA11 spilled to a RAM directory (31.91 GiB
written at 3.1 Gbp).  Host memory peaks at up to 24 bytes per base
(HOST_BYTES_PER_BASE), plus one spilled table while it is checked.
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
#: -b of every mapping stage (process_single_end's default)
B = 5000
#: peak host memory of a run per genome base: 53.69 GiB at 2.4 Gbp on an
#: 8-core machine (24.0 B per base), 57.15 GiB at 3.1 Gbp on a 32-core one
#: (19.8; both in PERF.md's hg19 table)
HOST_BYTES_PER_BASE = 24
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
    """Bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


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
    directory, the read sets, and the host, mesh and CLI outputs) and
    ``spill`` at most at once in the spill directory (one table)."""
    fasta = genome_bp + math.ceil(genome_bp / 70) + 4 * 32
    tables = (2 if spill else 4) * table_file_bytes(genome_bp)
    # per read set its FASTQ and the host and mesh outputs; the CLI maps
    # the first set once more
    reads = sum(n_reads * (2 * length + FASTQ_EXTRA
                           + (3 if i == 0 else 2) * (2 * length + MR_EXTRA))
                for i, (length, _, _) in enumerate(READ_SETS))
    return {"work": fasta + tables + reads + 2**20,
            "spill": table_file_bytes(genome_bp) if spill else 0}


def preflight(genome_bp: int, plan, *, n_reads: int, spill: bool,
              disk_limit: int, work_free: int, spill_free: int | None,
              mem_available: int, written: int = 0,
              n_cards: int | None = None,
              card_bytes: int | None = None):
    """Whether a run can finish, from numbers alone: (needs, problems).

    ``plan``: ``hbm_plan.plan_tables`` of the SE tables for ``genome_bp``;
    ``spill``: GA10 and GA11 go to a spill directory in RAM (``spill_free``
    bytes free), not to the disk; ``disk_limit``: bytes the machine may
    write; ``work_free``: free bytes in the work directory, which already
    holds ``written`` bytes of an earlier run; ``mem_available``: host
    memory, which the build's peak and one spilled table take;
    ``n_cards``/``card_bytes``: the CUDA cards and one card's memory (None
    on the CPU, which has no card to check).  ``problems`` lists each
    refusal with its numbers; empty means the run may start.
    """
    g = 2**30
    disk = disk_plan(genome_bp, n_reads, spill)
    ram = HOST_BYTES_PER_BASE * genome_bp + disk["spill"]
    needs = {"disk_gib": round(disk["work"] / g, 2),
             "spill_gib": round(disk["spill"] / g, 2),
             "host_ram_gib": round(ram / g, 2)}
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
                        f"GiB, {(spill_free or 0) / g:.2f} GiB free")
    if ram > mem_available:
        problems.append(f"host memory: the run needs {ram / g:.2f} GiB "
                        f"({HOST_BYTES_PER_BASE} B per base"
                        f"{' + one spilled table' if spill else ''}), "
                        f"{mem_available / g:.2f} GiB available")
    if n_cards is not None:
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
    return [f"the plan needs tp={plan.tp} and {n_cards} card(s) are "
            f"visible: the {plan.tp} shards take {whole / g:.2f} GiB on one "
            f"card, past its {(card_bytes - plan.reserve) / g:.2f} GiB budget "
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
                    help="device memory the plan assumes (default: the "
                         "card's)")
    ap.add_argument("--spill-dir", default=os.environ.get("WALTX_HG19_SPILL"),
                    help="directory in RAM for GA10 and GA11, which are "
                         "checked there and removed (default: "
                         "WALTX_HG19_SPILL, else none)")
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

    from walt_tpu_torch import cli, hbm_plan, native
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.core.single_end import process_single_end
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.genome import load_genome
    from walt_tpu_torch.glibc_rand import GlibcRand
    from walt_tpu_torch.index import io_walt
    from walt_tpu_torch.index.build import CONVERSIONS, build_table
    from walt_tpu_torch.ops import verify
    from walt_tpu_torch.parallel import make_mesh
    from walt_tpu_torch.synth import (
        codes_to_fastq, make_genome_repetitive, sample_reads,
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
    rep = {"genome_bp": bp, "n_reads": n_reads}
    if on_card:
        rep["card"] = {
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], check=True, capture_output=True,
                text=True, timeout=60).stdout.strip().splitlines(),
        }

    def save():
        rep["disk_written_bytes"] = tree_bytes(work)
        rep["disk_written_gib"] = round(rep["disk_written_bytes"] / 2**30, 2)
        rep["peak_rss_gib"] = peak_rss_gib()
        rep["elapsed_s"] = round(time.monotonic() - T0, 1)
        if on_card:
            with open(report, "w") as f:
                json.dump(rep, f, indent=1)

    # ---- stage 0: pre-flight --------------------------------------------
    os.makedirs(work, exist_ok=True)
    spill_in_ram = False
    if spill:
        os.makedirs(spill, exist_ok=True)
        # a spill directory on the work directory's file system is disk
        spill_in_ram = os.stat(spill).st_dev != os.stat(work).st_dev
    plan0 = hbm_plan.plan_tables(bp, 2, hbm, uniq_ratio=0.93)
    n_cards = torch.cuda.device_count() if on_card else None
    card_mem = hbm_plan.device_memory() if on_card else None
    needs, problems = preflight(
        bp, plan0, n_reads=n_reads, spill=spill_in_ram,
        disk_limit=disk_limit, work_free=free_bytes(work),
        spill_free=free_bytes(spill) if spill else None,
        mem_available=mem_available(), written=tree_bytes(work),
        n_cards=n_cards, card_bytes=card_mem)
    rep["preflight"] = dict(needs, plan=hbm_plan.describe(plan0),
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
        save()
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
        path = os.path.join(spill if spilled else work,
                            os.path.basename(index) + "_" + conv)
        note(f"building table {conv} (native counting-sort CSR) -> "
             f"{'spill' if spilled else 'work'} directory")
        t = time.time()
        g, ht = build_table(genome, conv, pattern, verbose=False,
                            sort_threads=os.cpu_count() or 1)
        build_s = time.time() - t
        t = time.time()
        io_walt.write_table(path, g, ht)
        write_s = time.time() - t
        m = {
            "build_s": round(build_s, 1),
            "write_s": round(write_s, 1),
            "entries": int(ht.index_size),
            "max_bucket": int(np.diff(ht.counter.astype(np.int64)).max()),
            "sha256": sha(ht.counter, ht.index),
            "file_bytes": os.path.getsize(path),
            "dir": "spill" if spilled else "work",
        }
        del g, ht
        gc.collect()
        if spilled:
            # the round trip of a table that leaves: read back, hash, remove
            m["spill_bytes"] = tree_bytes(spill)
            t = time.time()
            _, ht = io_walt.read_table(path, genome)
            ok = sha(ht.counter, ht.index) == m["sha256"]
            m["round_trip"] = {"read_s": round(time.time() - t, 1),
                               "sha_ok": ok}
            del ht
            os.remove(path)
            gc.collect()
            if not ok:
                raise AssertionError(f"round trip: {conv} differs")
        meta[conv] = m
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
    rep["spill"] = {"dir": spill, "tables": [c for c in CONVERSIONS
                                             if meta[c]["dir"] == "spill"],
                    "peak_gib": round(max([m.get("spill_bytes", 0)
                                           for m in meta.values()])
                                      / 2**30, 2)}
    save()

    # ---- stage 3: 5-file round trip -------------------------------------
    note("round trip: header")
    gm, size_of_index = io_walt.read_head(index)
    if gm.names != genome.names or not np.array_equal(gm.lengths,
                                                      genome.lengths):
        raise AssertionError("round trip: header differs")
    if size_of_index != max(m["entries"] for m in meta.values()):
        raise AssertionError("round trip: size_of_index differs")
    rt, counters = {}, []
    for conv in CONVERSIONS:
        if meta[conv]["dir"] == "spill":
            rt[conv] = meta[conv]["round_trip"]  # checked before removal
            continue
        cached = conv in ("CT00", "CT01")  # kept for the mapping stages
        note(f"round trip: {conv} (cached={cached})")
        t = time.time()
        reader = io_walt.read_table_cached if cached else io_walt.read_table
        g, ht = reader(index + "_" + conv, gm)
        if sha(ht.counter, ht.index) != meta[conv]["sha256"]:
            raise AssertionError(f"round trip: {conv} differs")
        rt[conv] = {"read_s": round(time.time() - t, 1), "sha_ok": True}
        if cached:
            counters.append(ht.counter)
        del g, ht
        gc.collect()
    rep["round_trip"] = rt
    # the plan bounds the runtime's own split of the SE tables (shards are
    # equal bucket-key ranges, uneven in entries)
    plan = hbm_plan.plan_tables(bp, 2, hbm, uniq_ratio=0.93,
                                counters=counters)
    rep["plan"] = hbm_plan.describe(plan)
    rep["heaviest_shard_entries"] = hbm_plan.heaviest_shard(bp, plan.tp,
                                                            counters)
    del counters
    save()
    # the tables' own split may need more cards than the pre-flight's plan
    for p in cards_problem(plan, n_cards, card_mem) if on_card else []:
        note(f"refused at stage 3: {p}")
        return 2

    # ---- stage 4: reads -------------------------------------------------
    fqs = {}
    for length, seed, name in READ_SETS:
        fq = fqs[length] = os.path.join(work, name)
        if not os.path.exists(fq + ".ok"):
            note(f"sampling {n_reads} x {length} bp bisulfite reads")
            codes, lens, _ = sample_reads(genome, n_reads, length, seed=seed)
            codes_to_fastq(codes, lens, fq)
            open(fq + ".ok", "w").close()
            del codes, lens
    del genome
    gc.collect()

    # ---- stage 5: exact host path ---------------------------------------
    if native.get_lib() is None:
        raise RuntimeError("the native library is required")

    def out_path(kind, length):
        return os.path.join(
            work, f"out_{kind}{'' if length == 100 else f'_{length}'}.mr")

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
    save()

    # ---- stage 6: the planned tp mesh -----------------------------------
    accel = "uniq" if plan.uniq else "key16"
    if on_card:
        devices = ([torch.device("cuda", i) for i in range(plan.tp)]
                   if n_cards >= plan.tp else [torch.device("cuda", 0)]
                   * plan.tp)
    else:
        devices = [torch.device("cpu")] * plan.tp
    virtual = len(set(devices)) < len(devices)
    mesh = make_mesh(devices, tp=plan.tp)
    distinct = mesh.distinct()
    note(f"mapping on {mesh} ({'virtual' if virtual else 'real'}), {accel} "
         f"shards, per the plan: {rep['plan']}")
    if on_card:
        gc.collect()
        for d in distinct:
            torch.cuda.synchronize(d)
        torch.cuda.empty_cache()
        held = {d: torch.cuda.memory_allocated(d) for d in distinct}
        for d in distinct:
            torch.cuda.reset_peak_memory_stats(d)

    def sync():
        if on_card:
            for d in distinct:
                torch.cuda.synchronize(d)

    backend = TorchBackend(mesh=mesh, tp_accel=accel)
    t = time.time()
    for s in ("_CT00", "_CT01"):  # the tables process_single_end maps on
        g, ht = io_walt.read_table_cached(index + s, gm)
        backend._device_table(g, ht, pattern, backend._needed_key_words(B))
    sync()
    setup_s = time.time() - t
    mesh_map = rep["mesh_map"] = {
        "tp": plan.tp, "dp": 1, "accel": accel, "virtual": virtual,
        "devices": [str(d) for d in distinct], "rungs": dict(backend.rungs),
        "setup_s": round(setup_s, 1), "by_length": {},
    }
    parities = rep["parities"] = {}
    for length, fq in fqs.items():
        out = out_path("mesh", length)
        fresh(out)
        launches0 = verify.stage_launches
        fb0, n0 = backend.fallback_reads, backend.total_reads
        t = time.time()
        stat = process_single_end(index, fq, out, batch_size=n_reads, b=B,
                                  max_mismatches=6, backend=backend)
        sync()
        mesh_s = time.time() - t
        mesh_map["by_length"][str(length)] = {
            "seconds": round(mesh_s, 1),
            "reads_per_s": round(n_reads / mesh_s, 1),
            "fallback_pct": round(100 * (backend.fallback_reads - fb0)
                                  / max(1, backend.total_reads - n0), 3),
            "unique": int(stat.unique),
            "verify_launches": verify.stage_launches - launches0,
        }
        parities[f"mesh_{length}"] = same_bytes(out_path("host", length),
                                                out)
        note(f"mesh {length} bp: {mesh_map['by_length'][str(length)]}, "
             f"parity {parities[f'mesh_{length}']}")
    launches = sum(v["verify_launches"] for v in mesh_map["by_length"].values())
    mesh_map["fallback_pct"] = round(
        100 * backend.fallback_reads / max(1, backend.total_reads), 3)
    mesh_map["verify_launches"] = launches
    mesh_map["plan_card_gib"] = round(plan.per_chip_bytes / 2**30, 2)
    if on_card:
        pools = backend.graphs.stats()
        per = mesh_map["per_device"] = {}
        for d in distinct:
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
        mesh_map["hbm_reserve_gib"] = TorchBackend.HBM_RESERVE / 2**30
        mesh_map["peak_device_gib"] = max(
            v["peak_allocated_gib"] for v in per.values())
    backend.free_tables()
    del backend
    gc.collect()
    save()

    # ---- stage 7: the CLI as users run it -------------------------------
    out_cli = out_path("cli", 100)
    stand_ins = [index + "_" + c for c in CONVERSIONS
                 if not os.path.exists(index + "_" + c)]
    argv = ["-i", index, "-r", fqs[100], "-o", out_cli, "--tp",
            str(plan.tp)] + ([] if on_card else ["--device", "cpu"])
    note(f"the CLI: waltx {' '.join(argv)}"
         f"{f' (stand-ins: {stand_ins})' if stand_ins else ''}")
    launches0 = verify.stage_launches
    try:
        for p in stand_ins:
            open(p, "w").close()
        t = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            rc = cli.main_map(argv)
        sync()
        cli_s = time.time() - t
    finally:
        for p in stand_ins:
            os.remove(p)
    rep["cli_map"] = {
        "flags": argv[6:], "rc": rc, "seconds": round(cli_s, 1),
        "reads_per_s": round(n_reads / cli_s, 1),
        "cards": n_cards, "stand_ins": [os.path.basename(p)
                                        for p in stand_ins],
        "verify_launches": verify.stage_launches - launches0,
    }
    parities["cli_100"] = same_bytes(out_path("host", 100), out_cli)

    # ---- parity ---------------------------------------------------------
    same = {k: all(p[k] for p in parities.values())
            for k in ("mr_bytes_equal", "mapstats_bytes_equal")}
    rep["parity"] = same
    rep["entry_limit_checked"] = True  # check_entry_limit ran per shard
    save()
    note(f"parity: {parities}; fallback {mesh_map['fallback_pct']}%, "
         f"verify launches {launches}")
    if not on_card:
        print(json.dumps(rep, indent=1))
    if rc != 0 or not all(same.values()):
        return 1
    # a device out-of-memory error maps the batch on the host, byte-identical:
    # the mesh must have done the work
    if any(v["fallback_pct"] >= 100 or (on_card and v["verify_launches"] <= 0)
           for v in mesh_map["by_length"].values()):
        note("the mesh resolved no read on the device")
        return 1
    note("hg19-scale proof complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
