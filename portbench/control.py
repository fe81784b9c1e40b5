#!/usr/bin/env python3
"""The output check's control: does the check fail a mapper that breaks
the configuration's exactness guarantee?

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--shifts 1] [--fed N]

For each seed it makes the cell's pool and the check's sample as a run
does, and puts the plain reference in the program's place, examining only
its first ``--shifts`` seed shifts of the pattern's 3 or 7: a mapper that
stops after the device's seed-0 phase, so that a read whose seed 0 holds
an error (a quarter of 100 bp reads at 1% errors) is missed, and a repeat
copy hit only by a later shift is never seen.  What that mapper writes for
the sample, each read's records as many times as a window of ``--fed``
reads (or pairs) cycled it (default: three passes over the pool and one
batch more), goes into an MR buffer with a ``.mapstats`` whose counts
agree with it, and the harness's own ``outcheck.check`` judges the buffer
as it judges a run's output.  It prints, per seed, ``correct`` and every
number compared beside its limit.  The bucket index runs on the card when
there is one.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_output(mode: str, pool, idx, answers, n_fed: int,
                   minimum: int):
    """(MR bytes, .mapstats text) of a mapper whose answers for the
    sampled reads are ``answers`` and that wrote nothing else, its counts
    consistent with what it wrote; ``minimum`` is the pattern's shortest
    mappable read."""
    from portbench import outcheck

    P = pool.n
    buf = b"".join(b"".join(lines) * (n_fed // P + (i < n_fed % P))
                   for i, (lines, _) in zip(idx.tolist(), answers))
    rec = outcheck.Records(buf)
    short = sum(int((lens < minimum).sum()) * (n_fed // P)
                + int((lens[: n_fed % P] < minimum).sum())
                for _, lens in pool.mates)
    if mode == "se":
        stats = (f"total_reads: {n_fed}\nunique: {rec.n}\n"
                 f"too_short: {2 * short}\n")
        return buf, stats
    hist = Counter(rec.frag_lengths().tolist()) if rec.n else Counter()
    stats = (f"total_read_pairs: {n_fed}\nunique: {rec.n}\nunique: 0\n"
             f"unique: 0\ntoo_short: {2 * short}\ntoo_short: 0\n"
             "fragment_length:" + "".join(f"\n    {k}: {v}"
                                          for k, v in sorted(hist.items()))
             + "\n")
    return buf, stats


def control_readings(root: str, workload: str, seed: int, shifts: int,
                     device: str, fed: int | None = None) -> dict:
    from portbench import harness, outcheck, reference

    spec = harness.load_spec(root)
    _, config, traffic = harness.find_cell(root, spec, workload)
    genome = harness.make_genome(config)
    pool = harness.Pool(genome, traffic, seed)
    n_fed = fed or 3 * pool.n + int(traffic["batch"])
    idx = outcheck.sample_indices(n_fed, pool.n, int(traffic["sample"]),
                                  seed)
    t0 = time.perf_counter()
    ref = outcheck.expected(genome, config, traffic, pool, idx, device)
    t1 = time.perf_counter()
    ctl = outcheck.expected(genome, config, traffic, pool, idx, device,
                            shifts=shifts)
    # the pairs the reference cannot judge stay unjudged for the control
    answers = [(lines, judged) for (lines, _), (_, judged) in zip(ctl, ref)]
    minimum = reference.PATTERNS[str(config["seed_pattern"])].min_read_len
    data, stats = control_output(traffic["mode"], pool, idx, answers, n_fed,
                                 minimum)
    got = outcheck.check(genome, config, traffic, pool, data, stats, n_fed,
                         seed, exp=ref)
    return dict(workload=workload, seed=seed, shifts=shifts, fed=n_fed,
                sampled=got["sampled"], unjudged=got["unjudged"],
                correct=got["correct"],
                checked={c["name"]: [c["value"], c["limit"]]
                         for c in got["numbers"]},
                reference_s=round(t1 - t0, 2))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--shifts", type=int, default=1)
    p.add_argument("--fed", type=int, default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for s in args.seeds.split(","):
        print(json.dumps(control_readings(ROOT, args.workload, int(s),
                                          args.shifts, device, args.fed)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
