"""Device time per stage of walt_tpu_torch's strand pass on one CUDA GPU.

Port of ``tools/device_profile.py``, which timed stage-truncated XLA
programs on a TPU and wrote ``DEVPROF.json``.  Here the pass runs whole
under an ``ops/stages.CudaStageTimer``, and for each stage the tool
reports:

- ``stage_ms``: stream time, the elapsed time between the CUDA events at
  the stage's two boundaries.  A steady call leaves the card idle most of
  the time, so this mostly measures how fast the host launches;
- ``stage_busy_ms``: device busy time, the union of the device intervals of
  the kernels, copies and fills the stage launched (each matched to its
  launching host call by the profiler's correlation id), from the same
  reps run again under ``torch.profiler``;
- ``stage_launches``: those device events, per call (median);
- ``stage_idle_share``: 1 - busy / stream (medians).

Modes: ``se`` is one ``se_fold.map_single_end_device`` call on one chunk
(both C->T tables, every seed; the backend's tier-1 shape:
``VERIFY_SLAB_T1``, worklist factor 1.5, ``full_mask`` as the backend
decides): the stages of each strand pass (``CT00.keys`` ...), each pass
whole (``CT00.strand``), and ``fold``.  ``pe`` is one
``pe_map.map_mate_device`` call (mate 1 against the same two tables, the
PE shapes ``pe_map.VERIFY_SLAB``/``WL_FACTOR``/``FLAT_FACTOR``), with
``flat`` in place of ``fold``.  ``unstaged`` counts device work launched
inside a pass after its last mark or between passes (0 when the marks
cover the pass).  Every profiled rep must pass
``chip_smoke.check_stage_split`` (marks in order, stage sums equal to the
pass totals, one fused launch per ``verify`` stage, no launch without its
device record); ``profile_windows`` says how many profiling windows that
took (``chip_smoke.profiled_stages``).  walt_tpu's ``worklist`` stage held the index gather, the
chromosome search and ``ok_head``/``ok_tail``; the port's fused verify
kernel does them, so they count in its ``verify`` stage.

``seconds`` (minimum) and ``seconds_median``: wall time to a synchronize of
``rtt`` (a trivial kernel and its copy to the host), ``strand`` (one
strand pass against the '+' table), ``full_se`` and ``full_se_seed0``
(the SE step with every seed and with seed 0 only, as the backend's
phases B and A).  Every timed quantity is a warm-up call (the first builds
the kernels with nvcc and grows the allocator) and then 5 reps.

Usage, from the repository root:

    python tools/device_profile_torch.py [index] [fastq] [chunk]
        [--device cuda|cpu] [--out PATH]

Defaults: ``chip_smoke.py``'s data under ``build/smoke_data/`` (built when
missing): its index, its 1,000,000 reads, and ``pairs_1.fq`` as the mates
(with an explicit ``fastq``, its reads are the mates too); chunk 131,072,
the backend's.  Environment switches, as the JAX tool's:
``WALTX_PROF_ONE`` (the '+' table only: its strand pass, no ``full_se``,
no PE), ``WALTX_PROF_NOUNIQ`` (the entry-space search on u32 word-0 key
words instead of the uniq runs), ``WALTX_PROF_QUICK`` (``rtt`` and the
full SE step only), ``WALTX_PROF_WL`` (the SE worklist factor).  A full
run on a card writes the report to ``DEVPROF_TORCH.json`` at the
repository root (``--out`` elsewhere); runs cut by ``WALTX_PROF_ONE`` or
``WALTX_PROF_QUICK`` print it only.  ``--device cpu`` is a toy-size
rehearsal: it makes every call once, prints the report's keys and stage
names with no number (nothing was measured on a device) and writes
nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REPS = 5
B_CAP, MAX_MM = 5000, 6
NOTE = ("stage_ms is stream time between CUDA events (mostly host launch "
        "rate on an idle card); stage_busy_ms is the device time of the "
        "work each stage launched (matched by correlation id); walt_tpu's "
        "worklist stage held the index gather, chromosome search and "
        "ok_head/ok_tail, which the port's fused kernel does in verify")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("index", nargs="?")
    p.add_argument("fastq", nargs="?")
    p.add_argument("chunk", nargs="?", type=int, default=131072)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=os.path.join(REPO, "DEVPROF_TORCH.json"))
    args = p.parse_args(argv)
    if args.index is not None and args.fastq is None:
        p.error("an index needs its fastq")
    return args


def stat(values) -> dict:
    return {"median": statistics.median(values), "min": min(values)}


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    import chip_smoke as cs
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.index import io_walt
    from walt_tpu_torch.ops import device_index, pe_map, pipeline, se_fold
    from walt_tpu_torch.ops import stages as st

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("device_profile_torch: no CUDA device (use "
                         "--device cpu for the rehearsal)")
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    if args.index is None:
        index, fastq, pe = cs.build_data(cs.DATA, cs.GENOME_BASES,
                                         cs.N_READS, cs.N_PAIRS, cs.READ_LEN)
        mate = pe[0]
    else:
        index, fastq, mate = args.index, args.fastq, args.fastq
    one = bool(os.environ.get("WALTX_PROF_ONE"))
    quick = bool(os.environ.get("WALTX_PROF_QUICK"))
    chunk = args.chunk

    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(index)
    names = ["CT00"] if one else ["CT00", "CT01"]
    tables = [io_walt.read_table_cached(f"{index}_{n}", gm) for n in names]
    backend = TorchBackend(device=device, chunk=chunk)
    backend.table_budget_hint = 2  # what the SE driver sets (2 tables)
    devs, bits, ubits = [], [], []
    for g, ht in tables:
        dt, dev = backend._device_table(g, ht, pattern, 1)
        devs.append(dev)
        bits.append(dt.max_bucket_bits)
        ubits.append(dt.uniq_bits)
    if os.environ.get("WALTX_PROF_NOUNIQ"):
        # the entry-space search, for A/B against the uniq run path: a uniq
        # table keeps no key words, so give it u32 word 0
        for dev, ub in zip(devs, ubits):
            if ub:
                dev["key_words"] = device_index.build_key_words_device(
                    dev["pseq"], dev["index"], pattern, n_key_words=1)
        ubits = [0 for _ in ubits]

    def first_chunk(path):
        codes, lens = cs.load_reads(path, chunk)
        _, _, pc, pl = next(backend._chunks(codes, lens, pattern, chunk))
        return pc, pl, TorchBackend._full_mask(lens, pattern)

    pc, pl, fm = first_chunk(fastq)
    W = int(pc.shape[1])
    kw = dict(pattern_name="3", ag_wildcard=False,
              verify_slab=pipeline.VERIFY_SLAB_T1,
              wl_factor=float(os.environ.get("WALTX_PROF_WL", "1.5")),
              exact_b=False, full_mask=fm)

    def strand(stages=None):
        d = devs[0]
        with st.strand_pass(stages, 0):
            return pipeline.map_strand_core(
                pc, pl, B_CAP, MAX_MM, d["pseq"], d["counter"], d["index"],
                d["key_words"], d["start_index"], d["bucket_flagged"],
                search_bits=bits[0], uniq_words=d.get("uniq_words"),
                uniq_off=d.get("uniq_off"),
                uniq_counter=d.get("uniq_counter"), uniq_bits=ubits[0],
                stages=stages, **kw)

    def se_step(stages=None, seeds=None):
        return se_fold.map_single_end_device(
            pc, pl, B_CAP, MAX_MM, tuple(devs), search_bits=tuple(bits),
            uniq_bits=tuple(ubits), seeds=seeds, stages=stages, **kw)

    mc = ml = mfm = None
    if not (one or quick):
        mc, ml, mfm = first_chunk(mate)

    def pe_step(stages=None):
        return pe_map.map_mate_device(
            mc, ml, B_CAP, MAX_MM, tuple(devs), pattern_name="3",
            ag_wildcard=False, search_bits=tuple(bits),
            verify_slab=pe_map.VERIFY_SLAB, cand_slab=backend.cand_slab,
            wl_factor=pe_map.WL_FACTOR, flat_factor=pe_map.FLAT_FACTOR,
            uniq_bits=tuple(ubits), full_mask=mfm, stages=stages)

    walls = {"rtt": lambda: (pc[:1, :1] + 1).cpu()}
    if not quick:
        walls["strand"] = strand
    if not one:
        walls["full_se"] = se_step
        walls["full_se_seed0"] = lambda: se_step(seeds=(0,))
    modes = {}
    if not quick:
        modes["se"] = (strand if one else se_step, 1 if one else 2)
    if not (one or quick):
        modes["pe"] = (pe_step, 2)

    report = dict(chunk=chunk, W=W, search_bits=bits, uniq_bits=ubits,
                  full_mask=fm, pe_full_mask=mfm, rungs=backend.rungs,
                  reps=REPS, note=NOTE)
    if not on_card:
        for fn in walls.values():
            fn()
        report["device"] = "cpu rehearsal: nothing measured"
        report["seconds"] = {k: None for k in walls}
        report["seconds_median"] = dict(report["seconds"])
        report["us_per_read_full_se"] = None
        for mode, (step, _) in modes.items():
            log = st.StageLog()
            step(log)
            keys = [key_name(names, t, s) for t, s in log.names()]
            keys += [f"{n}.strand" for n in names[:1 if one else 2]]
            for k in ("stage_ms", "stage_busy_ms", "stage_launches",
                      "stage_idle_share"):
                extra = ["unstaged"] if k in ("stage_busy_ms",
                                              "stage_launches") else []
                report.setdefault(k, {})[mode] = {x: None
                                                  for x in keys + extra}
            report.setdefault("profile_windows", {})[mode] = None
        print(json.dumps(report, indent=1))
        return 0

    card = cs.card_line()
    report["device"] = card
    report["torch"] = f"{torch.__version__} (CUDA {torch.version.cuda})"
    print(f"card: {card}", flush=True)

    def sync():
        torch.cuda.synchronize(device)

    secs = {}
    for name, fn in walls.items():
        fn()  # warm-up
        sync()
        secs[name] = []
        for _ in range(REPS):
            t = time.perf_counter()
            fn()
            sync()
            secs[name].append(time.perf_counter() - t)
    report["seconds"] = {k: min(v) for k, v in secs.items()}
    report["seconds_median"] = {k: statistics.median(v)
                                for k, v in secs.items()}
    if "full_se" in secs:
        report["us_per_read_full_se"] = 1e6 * min(secs["full_se"]) / chunk

    trace = os.path.join(REPO, "build", "profile", "stage_trace.json")
    for mode, (step, n_pass) in modes.items():
        step(st.CudaStageTimer(device))  # warm-up
        sync()
        stream = []
        for _ in range(REPS):
            timer = st.CudaStageTimer(device)
            step(timer)
            sync()
            stream.append(timer.stream_ms())
        step_stage = (None if one else st.SE_STEP_STAGE if mode == "se"
                      else st.PE_STEP_STAGE)
        _, _, splits, attempts = cs.profiled_stages(
            step, device, n_pass, step_stage, trace, reps=REPS)
        report.setdefault("profile_windows", {})[mode] = attempts
        keys = list(stream[0])
        name = {k: key_name(names, *k) for k in keys}
        ms = {name[k]: stat([s[k] for s in stream]) for k in keys}
        busy = {name[k]: stat([s[k]["busy_ms"] if k in s else 0.0
                               for s in splits]) for k in keys}
        keys.append((None, None))
        name[(None, None)] = "unstaged"
        busy["unstaged"] = stat([s.get((None, None), {}).get("busy_ms", 0.0)
                                 for s in splits])
        launches = {name[k]: statistics.median(
            s.get(k, {}).get("launches", 0) for s in splits) for k in keys}
        report.setdefault("stage_ms", {})[mode] = ms
        report.setdefault("stage_busy_ms", {})[mode] = busy
        report.setdefault("stage_launches", {})[mode] = launches
        report.setdefault("stage_idle_share", {})[mode] = {
            k: 1 - busy[k]["median"] / v["median"] if v["median"] else None
            for k, v in ms.items()}
        print(f"{mode} (median of {REPS}: stream ms, device busy ms, "
              f"launches, idle share):", flush=True)
        for k, v in ms.items():
            share = report["stage_idle_share"][mode][k]
            print(f"  {k:18s} {v['median']:9.3f} {busy[k]['median']:9.3f} "
                  f"{launches[k]:6g}  "
                  f"{'-' if share is None else f'{share:.3f}'}", flush=True)
    print(json.dumps(report, indent=1), flush=True)
    if modes and not one:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    if "us_per_read_full_se" in report:
        print(json.dumps({"us_per_read_full_se":
                          report["us_per_read_full_se"]}))
    return 0


def key_name(names, table, stage) -> str:
    """A report key: ``CT00.keys`` for a strand pass's stage or total,
    ``fold`` / ``flat`` for a step stage."""
    return stage if table is None else f"{names[table]}.{stage}"


if __name__ == "__main__":
    sys.exit(main())
