"""hg19-scale proof of walt_tpu_torch on an NVIDIA card: a 3.1 Gbp index
build, the 5-file round trip, and mapping parity on the planned tp mesh.

Port of ``tools/hg19_scale.py``; imports only ``walt_tpu_torch``.  Stages:

1. synthesize a repeat-structured genome (``walt_tpu_torch.synth``, 4
   chromosomes, seed 11), write it as FASTA and load it back as makedb does
   (``load_genome`` with ``GlibcRand(0)``);
2. build all four converted-genome tables with the native counting-sort
   builder and write the WALT 5-file index, one table at a time so host
   memory stays bounded;
3. round trip: read every table back and hold its arrays to their sha256;
4. sample bisulfite reads;
5. map them on the exact host path (``native.se_exact`` for every read);
6. map them on the tp mesh that ``walt_tpu_torch.hbm_plan`` plans for these
   tables on this card (its tp and accel, the heaviest shard measured on
   the SE tables' counters; a virtual mesh on the first card when there are
   fewer cards than tp) and hold the MR and .mapstats bytes equal to stage
   5's.

Past 2^31 positions this exercises what int32 carriers of u32 values must
survive: table entries and chromosome starts >= 2^31 in the fused verify
stage, the uniq build and the result packs, and the per-shard entry limit.

Run on the card, from the repository root::

    python tools/hg19_scale_torch.py

Env: WALTX_HG19_BP (genome bases, default 3_100_000_000), WALTX_HG19_READS
(50_000), WALTX_HG19_DIR (work directory, default
<repo>/bench_cache/hg19_torch), WALTX_HG19_REPORT (default
<repo>/HG19SCALE_TORCH.json).  Stages are stamped in the work directory,
so a rerun there resumes after the last completed one.  The report is
written only from a run on a CUDA card, with the card's name and power
limit; ``--device cpu --hbm-gib G`` rehearses the stages at a small
WALTX_HG19_BP and prints the report instead.

Disk: each table file holds the converted genome and its u32 entries, 5
bytes per base, so the FASTA and four tables of 3.1 Gbp take ~61 GiB.
Host memory peaks at ~18 bytes per base while a table is built (54 GB at
3.1 Gbp).
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

BP = int(os.environ.get("WALTX_HG19_BP", 3_100_000_000))
N_READS = int(os.environ.get("WALTX_HG19_READS", 50_000))
WORK = os.environ.get(
    "WALTX_HG19_DIR", os.path.join(REPO, "bench_cache", "hg19_torch"))
REPORT = os.environ.get(
    "WALTX_HG19_REPORT", os.path.join(REPO, "HG19SCALE_TORCH.json"))
T0 = time.monotonic()


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


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(memoryview(np.ascontiguousarray(a)).cast("B"))
    return h.hexdigest()


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--hbm-gib", type=float, default=None,
                    help="device memory the plan assumes (default: the "
                         "card's)")
    args = ap.parse_args(argv)

    import torch

    from walt_tpu_torch import hbm_plan, native
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.core.single_end import process_single_end
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.genome import load_genome
    from walt_tpu_torch.glibc_rand import GlibcRand
    from walt_tpu_torch.index import io_walt
    from walt_tpu_torch.index.build import CONVERSIONS, build_table
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
    rep = {"genome_bp": BP, "n_reads": N_READS}
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
        rep["peak_rss_gib"] = peak_rss_gib()
        rep["elapsed_s"] = round(time.monotonic() - T0, 1)
        if on_card:
            with open(REPORT, "w") as f:
                json.dump(rep, f, indent=1)

    os.makedirs(WORK, exist_ok=True)
    pattern = get_pattern("3")
    fasta = os.path.join(WORK, "genome.fa")
    index = os.path.join(WORK, "hg19s.dbindex")
    meta_path = os.path.join(WORK, "build_meta.json")

    # ---- stage 1: genome ------------------------------------------------
    if not os.path.exists(fasta + ".ok"):
        note(f"generating a {BP / 1e9:.2f} Gbp repeat-structured genome")
        t = time.time()
        g = make_genome_repetitive(BP, n_chroms=4, seed=11)
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
    if genome.length_of_genome != BP:
        raise AssertionError(f"genome of {genome.length_of_genome} bases, "
                             f"not {BP}")
    rep["max_position"] = int(genome.start_index[-1]) - 1
    rep["positions_beyond_int32"] = rep["max_position"] >= 2**31

    # ---- stage 2: build + write the 4 tables, one at a time -------------
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}
    for conv in CONVERSIONS:
        if conv in meta:
            continue
        note(f"building table {conv} (native counting-sort CSR)")
        t = time.time()
        g, ht = build_table(genome, conv, pattern, verbose=False)
        build_s = time.time() - t
        t = time.time()
        io_walt.write_table(index + "_" + conv, g, ht)
        write_s = time.time() - t
        meta[conv] = {
            "build_s": round(build_s, 1),
            "write_s": round(write_s, 1),
            "entries": int(ht.index_size),
            "max_bucket": int(np.diff(ht.counter.astype(np.int64)).max()),
            "sha256": sha(ht.counter, ht.index),
            "file_bytes": os.path.getsize(index + "_" + conv),
        }
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
        sum(m["file_bytes"] for m in meta.values()) / 2**30, 2)
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
    plan = hbm_plan.plan_tables(BP, 2, hbm, uniq_ratio=0.93,
                                counters=counters)
    rep["plan"] = hbm_plan.describe(plan)
    rep["heaviest_shard_entries"] = hbm_plan.heaviest_shard(BP, plan.tp,
                                                            counters)
    del counters
    save()

    # ---- stage 4: reads -------------------------------------------------
    fq = os.path.join(WORK, "reads.fastq")
    if not os.path.exists(fq + ".ok"):
        note(f"sampling {N_READS} bisulfite reads")
        codes, lens, _ = sample_reads(genome, N_READS, 100, seed=5)
        codes_to_fastq(codes, lens, fq)
        open(fq + ".ok", "w").close()
        del codes, lens
    del genome
    gc.collect()

    # ---- stage 5: exact host path ---------------------------------------
    if native.get_lib() is None:
        raise RuntimeError("the native library is required")

    def fresh(path):
        open(path, "w").close()
        open(path + ".mapstats", "w").close()

    out_host = os.path.join(WORK, "out_host.mr")
    note("mapping on the exact host path (native se_exact)")
    fresh(out_host)
    t = time.time()
    stat = process_single_end(index, fq, out_host, batch_size=N_READS,
                              max_mismatches=6, backend=HostExactBackend())
    host_s = time.time() - t
    rep["host_map"] = {
        "seconds": round(host_s, 1), "reads_per_s": round(N_READS / host_s, 1),
        "unique": int(stat.unique), "ambiguous": int(stat.ambiguous),
        "unmapped": int(stat.unmapped),
    }
    save()

    # ---- stage 6: the planned tp mesh -----------------------------------
    accel = "uniq" if plan.uniq else "key16"
    if on_card:
        n_cards = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(plan.tp)]
                   if n_cards >= plan.tp else [torch.device("cuda", 0)]
                   * plan.tp)
        for d in dict.fromkeys(devices):
            torch.cuda.reset_peak_memory_stats(d)
    else:
        devices = [torch.device("cpu")] * plan.tp
    virtual = len(set(devices)) < len(devices)
    mesh = make_mesh(devices, tp=plan.tp)
    note(f"mapping on {mesh} ({'virtual' if virtual else 'real'}), {accel} "
         f"shards, per the plan: {rep['plan']}")
    from walt_tpu_torch.ops import verify

    backend = TorchBackend(mesh=mesh, tp_accel=accel)
    out_mesh = os.path.join(WORK, "out_mesh.mr")
    fresh(out_mesh)
    verify.stage_launches = 0
    t = time.time()
    stat2 = process_single_end(index, fq, out_mesh, batch_size=N_READS,
                               max_mismatches=6, backend=backend)
    mesh_s = time.time() - t
    launches = verify.stage_launches
    rep["mesh_map"] = {
        "seconds": round(mesh_s, 1), "reads_per_s": round(N_READS / mesh_s, 1),
        "tp": plan.tp, "dp": 1, "accel": accel, "virtual": virtual,
        "devices": [str(d) for d in mesh.distinct()],
        "rungs": dict(backend.rungs),
        "fallback_pct": round(
            100 * backend.fallback_reads / max(1, backend.total_reads), 3),
        "unique": int(stat2.unique), "verify_launches": launches,
    }
    if on_card:
        rep["mesh_map"]["peak_device_gib"] = round(max(
            torch.cuda.max_memory_allocated(d)
            for d in mesh.distinct()) / 2**30, 2)
    backend.free_tables()

    # ---- parity ---------------------------------------------------------
    same = {k: open(out_host + s, "rb").read() == open(out_mesh + s,
                                                       "rb").read()
            for k, s in (("mr_bytes_equal", ""),
                         ("mapstats_bytes_equal", ".mapstats"))}
    rep["parity"] = same
    rep["entry_limit_checked"] = True  # check_entry_limit ran per shard
    save()
    note(f"parity: {same}; fallback {rep['mesh_map']['fallback_pct']}%, "
         f"verify launches {launches}")
    if not on_card:
        print(json.dumps(rep, indent=1))
    if not all(same.values()):
        return 1
    # a device out-of-memory error maps the batch on the host, byte-identical:
    # the mesh must have done the work
    if backend.fallback_reads >= backend.total_reads or (
            on_card and launches <= 0):
        note("the mesh resolved no read on the device")
        return 1
    note("hg19-scale proof complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
