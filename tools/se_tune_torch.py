"""Sweep walt_tpu_torch's SE tier-1 shapes end to end on one CUDA GPU.

Port of ``tools/se_tune.py``.  A wider tier-1 verify slab or worklist keeps
more reads on the device (less host replay) at some device time; this
maps the same reads under each ``(verify_slab_t1, wl1)`` of walt_tpu's
list with one ``TorchBackend``, so the tables are placed once:

    (8, 1.5)  the default, which chip_smoke.py's phase 6 holds to the exact
              host path; (12, 2.0); (16, 2.5); (8, 1.25)

For each setting the backend's ``verify_slab_t1`` is set, then
``reset_adaptive()``, then ``_wl1``, as the JAX tool does, and
``process_single_end`` runs ``REPS`` times (batch 500,000, ``-m 6``); the
best time counts.  A run at the defaults first builds the kernels and
places the tables.  Per setting the tool reports reads/s and seconds (best,
and every rep: the run-to-run spread), the fallback share (of the best rep,
and of every rep: the backend's phase schedule and ``_wl1`` adapt from rep
to rep), ``_wl1`` at the end (the backend widens it after a batch that
spilled more than 5%), the
rung per table, the working set (peak reserved device memory less the
tables, as chip_smoke.py measures it), the kernels' launches in the last
rep, and whether the MR and ``.mapstats`` bytes equal the first setting's.

Usage, from the repository root:

    python tools/se_tune_torch.py [index] [fastq] [n] [--device cuda|cpu]
        [--out PATH]

Defaults: ``chip_smoke.py``'s data under ``build/smoke_data/`` (built when
missing), all its 1,000,000 reads; ``n`` maps the first ``n`` reads.  The
last line of the output is one JSON object ``{"results", "best", "card"}``
(``card``: nvidia-smi's name and power limit); a card run also writes it
to ``SE_TUNE_TORCH.json`` at the repository root (``--out`` elsewhere).
``--device cpu`` is a toy-size rehearsal: it runs every setting, prints
the keys with no measured number (``bytes_identical`` and ``rungs`` are
kept) and writes no report.  There is no fallback from the card to the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: (verify_slab_t1, wl1), walt_tpu's list; the first is the default
SETTINGS = [(8, 1.5), (12, 2.0), (16, 2.5), (8, 1.25)]
REPS = 3
BATCH = 500_000
MAX_MM = 6


def parse(argv, n_files: int, what: str, report: str):
    """Arguments ``[index] [file ...] [n] --device --out`` of a tune tool."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("index", nargs="?")
    p.add_argument("files", nargs="*", metavar="fastq")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=os.path.join(REPO, report))
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():  # before any data is built
            p.exit(1, f"{p.prog}: no CUDA device (use --device cpu for the "
                      f"rehearsal)\n")
    args.n = None
    if len(args.files) == n_files + 1:
        args.n = int(args.files.pop())
    if (args.index is None) != (not args.files) or \
            args.files and len(args.files) != n_files:
        p.error(f"give an index with its {what}, or neither")
    return args


class Sweep:
    """The device, the data, one backend and the bookkeeping of a sweep:
    :meth:`run` maps the reads once, :meth:`row` reports a setting.  Use
    it in a ``with`` block: its work directory goes at the end."""

    def __init__(self, args, files):
        import torch

        import chip_smoke as cs
        from walt_tpu_torch.core.torch_backend import TorchBackend

        self.cs = cs
        self.on_card = args.device == "cuda"
        self.device = (torch.device("cuda", 0) if self.on_card
                       else torch.device("cpu"))
        self.card = (cs.card_line() if self.on_card
                     else "cpu rehearsal: nothing measured")
        self.work = tempfile.mkdtemp(prefix="tune_")
        if args.n:
            files = [cs.head_fastq(f, os.path.join(self.work, f"in{i}.fq"),
                                   args.n) for i, f in enumerate(files)]
        with open(files[0]) as f:
            self.n = sum(1 for _ in f) // 4
        self.files = files
        self.out = os.path.join(self.work, "tune.mr")
        self.backend = TorchBackend(device=self.device)
        self.golden = None
        self.held = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        import shutil

        shutil.rmtree(self.work, ignore_errors=True)

    def run(self, process, *args, **kw) -> dict:
        """One ``process(*args, *files, out, backend=...)`` run: its wall
        seconds, fallback share and kernel launches."""
        from walt_tpu_torch import perf

        b = self.backend
        self.cs.fresh(self.out)
        self.cs.zero_counts()
        c0 = perf.counters()
        t0 = time.perf_counter()
        process(*args, *self.files, self.out, backend=b, **kw)
        t1 = time.perf_counter()
        c1 = perf.counters()
        fb, n = (c1.get(k, 0) - c0.get(k, 0)
                 for k in ("backend.fallback_reads", "backend.reads"))
        return dict(seconds=t1 - t0, fallback_pct=100 * fb / max(1, n),
                    launches=self.cs.counts())

    def start(self):
        """Before a setting's runs: the peak memory counters from here."""
        if self.on_card:
            self.held = self.cs.start_memory(self.device, self.backend)

    def row(self, params: dict, measured: dict) -> dict:
        """A setting's report row: its ``params``, what it ``measured``
        and its working set (None in a CPU rehearsal), the rung per table,
        and whether its output bytes equal the first setting's."""
        with open(self.out, "rb") as a, open(self.out + ".mapstats",
                                             "rb") as m:
            blob = (a.read(), m.read())
        if self.golden is None:
            self.golden = blob
        measured["working_set_gib"] = (
            self.cs.working_set(self.device, self.held, self.backend)
            if self.on_card else None)
        row = dict(params)
        row.update({k: v if self.on_card else None
                    for k, v in measured.items()})
        row["rungs"] = dict(self.backend.rungs)
        row["bytes_identical"] = blob == self.golden
        print(json.dumps(row), file=sys.stderr, flush=True)
        return row

    def finish(self, results, rate: str, out: str) -> int:
        """Print the report (and write it from a card run); 1 when a
        setting's output differs from the first's."""
        best = (max(results, key=lambda r: r[rate]) if self.on_card
                else None)
        report = {"results": results, "best": best, "card": self.card}
        if self.on_card:
            with open(out, "w") as f:
                json.dump(report, f, indent=1)
            print(f"wrote {out}", file=sys.stderr, flush=True)
        print(json.dumps(report), flush=True)
        if not all(r["bytes_identical"] for r in results):
            print("a setting's output differs from the first setting's",
                  file=sys.stderr, flush=True)
            return 1
        return 0


def main(argv=None) -> int:
    args = parse(argv, 1, "fastq", "SE_TUNE_TORCH.json")
    import chip_smoke as cs
    from walt_tpu_torch.core.single_end import process_single_end

    if args.index is None:
        index, fastq, _ = cs.build_data(cs.DATA, cs.GENOME_BASES, cs.N_READS,
                                        cs.N_PAIRS, cs.READ_LEN)
        files = [fastq]
    else:
        index, files = args.index, args.files
    with Sweep(args, files) as sw:
        b = sw.backend

        def run():
            return sw.run(process_single_end, index, batch_size=BATCH,
                          max_mismatches=MAX_MM)

        run()  # kernels built, tables placed
        results = []
        for slab, wl in SETTINGS:
            b.verify_slab_t1 = slab
            b.reset_adaptive()
            b._wl1 = wl
            sw.start()
            reps = [run() for _ in range(REPS)]
            best = min(reps, key=lambda r: r["seconds"])
            results.append(sw.row(
                dict(slab=slab, wl=wl),
                dict(reads_per_s=sw.n / best["seconds"],
                     seconds=best["seconds"],
                     seconds_all=[r["seconds"] for r in reps],
                     fallback_pct=best["fallback_pct"],
                     fallback_pct_all=[r["fallback_pct"] for r in reps],
                     wl1_end=b._wl1,
                     launches=reps[-1]["launches"])))
        return sw.finish(results, "reads_per_s", args.out)


if __name__ == "__main__":
    sys.exit(main())
