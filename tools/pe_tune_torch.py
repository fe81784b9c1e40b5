"""Sweep walt_tpu_torch's PE mate-step shapes end to end on one CUDA GPU.

Port of ``tools/pe_tune.py``.  PE keeps every candidate within ``-m`` (no
0/1-mismatch early exit), so its verify slab, worklist and flat stream
spill more than SE's; this maps the same pairs under each
``(pe_verify_slab, pe_wl, pe_flat_factor)`` of walt_tpu's list with one
``TorchBackend``, so the four tables are placed once:

    (8, 2, 8)  walt_tpu's round-3 shapes; (8, 1.5, 8); (16, 2.5, 10);
    (16, 3, 12)  the default, which chip_smoke.py's phase 8 holds to the
                 exact host path; (24, 3, 12)

For each setting the backend's three attributes are set and
``process_paired_end`` runs twice (batch 150,000, ``-m 6``): a warm run and
a timed run, as in the JAX tool; a run at the defaults first builds the
kernels and places the tables.  Per setting the tool reports pairs/s and
seconds of the timed run, the warm run's seconds (the two give the
run-to-run spread), the fallback share (reads of both mates), the working
set (peak reserved device memory less the tables, as chip_smoke.py
measures it), the kernels' launches in the timed run, the rung per table,
and whether the MR and ``.mapstats`` bytes equal the first setting's.

Usage, from the repository root:

    python tools/pe_tune_torch.py [index] [fastq_1 fastq_2] [n]
        [--device cuda|cpu] [--out PATH]

Defaults: ``chip_smoke.py``'s ``pairs_1.fq``/``pairs_2.fq`` (500,000 pairs)
and index under ``build/smoke_data/`` (built when missing); ``n`` maps the
first ``n`` pairs.  The last line of the output is one JSON object
``{"results", "best", "card"}``; a card run also writes it to
``PE_TUNE_TORCH.json`` at the repository root (``--out`` elsewhere).
``--device cpu`` is a toy-size rehearsal, as for ``tools/se_tune_torch.py``.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from se_tune_torch import MAX_MM, Sweep, parse  # noqa: E402

#: (pe_verify_slab, pe_wl, pe_flat_factor), walt_tpu's list
SETTINGS = [(8, 2.0, 8), (8, 1.5, 8), (16, 2.5, 10), (16, 3.0, 12),
            (24, 3.0, 12)]
BATCH = 150_000


def main(argv=None) -> int:
    args = parse(argv, 2, "two fastq files", "PE_TUNE_TORCH.json")
    import chip_smoke as cs
    from walt_tpu_torch.core.paired_end import process_paired_end

    if args.index is None:
        index, _, files = cs.build_data(cs.DATA, cs.GENOME_BASES, cs.N_READS,
                                        cs.N_PAIRS, cs.READ_LEN)
    else:
        index, files = args.index, args.files
    with Sweep(args, list(files)) as sw:
        b = sw.backend

        def run():
            return sw.run(process_paired_end, index, batch_size=BATCH,
                          max_mismatches=MAX_MM)

        run()  # kernels built, tables placed
        results = []
        for slab, wl, flat in SETTINGS:
            b.pe_verify_slab, b.pe_wl, b.pe_flat_factor = slab, wl, flat
            sw.start()
            warm = run()
            rep = run()
            results.append(sw.row(
                dict(slab=slab, wl=wl, flat=flat),
                dict(pairs_per_s=sw.n / rep["seconds"],
                     seconds=rep["seconds"], warm_s=warm["seconds"],
                     fallback_pct=rep["fallback_pct"],
                     launches=rep["launches"])))
        return sw.finish(results, "pairs_per_s", args.out)


if __name__ == "__main__":
    sys.exit(main())
