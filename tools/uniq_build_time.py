"""Time the uniq run-index build on one card, in turns with another tree's.

The build (``walt_tpu_torch.ops.device_index.build_uniq_device``) runs on the
CT00 table of ``chip_smoke.py``'s genome (a 128 Mbp repetitive genome, two
chromosomes, seed 42: 127,999,928 entries), at each chunk size given, and
beside it the build of another tree, for example the commit before the
bounded build, unpacked with ``git archive`` into a directory that
``.gitignore`` lists.  Calls go in turns (other, chunks, chunks reversed,
other), ``--reps`` builds each.  Every build is synchronized and timed on
the host clock, with its peak allocated memory above the placed table and
its outputs; every output is held equal to the first.

Run from the repository root, on the card::

    git archive <commit> walt_tpu_torch/ops/device_index.py | \\
        (mkdir -p build/other && tar -x -C build/other)
    python tools/uniq_build_time.py --other build/other

Prints the card's name and power limit, then one JSON line.  ``--device
cpu --bases 2000000`` rehearses it without a card (no memory figures).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def load_other(root: str):
    """The ``device_index`` module of the tree at ``root``, loaded beside
    this tree's (its imports of the rest of the package resolve here)."""
    path = os.path.join(root, "walt_tpu_torch", "ops", "device_index.py")
    spec = importlib.util.spec_from_file_location("other_device_index", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look themselves up here
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None,
                    help="a tree whose device_index build runs in turns")
    ap.add_argument("--chunks", default="1048576,2097152",
                    help="comma-separated chunk sizes of this tree's build")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--bases", type=int, default=128_000_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.ops import device_index
    from walt_tpu_torch.synth import make_genome_repetitive

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("uniq_build_time: no CUDA device is available")
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    if on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip(), flush=True)

    pattern = get_pattern("3")
    t0 = time.perf_counter()
    genome = make_genome_repetitive(args.bases, n_chroms=2, seed=42)
    g, ht = build_table(genome, "CT00", pattern, verbose=False)
    dev = device_index.place_table(
        device_index.build_device_table(g, ht, pattern), device)
    n = int(ht.index.shape[0])
    del genome, g, ht
    setup_s = time.perf_counter() - t0

    builds = {f"chunk {c}": (lambda c=c: device_index.build_uniq_device(
        dev["pseq"], dev["index"], dev["counter"], pattern, chunk=c))
        for c in (int(x) for x in args.chunks.split(","))}
    order = list(builds)
    if args.other:
        other = load_other(args.other)
        builds["other"] = lambda: other.build_uniq_device(
            dev["pseq"], dev["index"], dev["counter"], pattern)
        order = ["other"] + order + order[::-1] + ["other"]
    else:
        order = order + order[::-1]

    secs = {k: [] for k in builds}
    peak = dict.fromkeys(builds)
    first = None
    for name in order:
        for _ in range(args.reps):
            if on_card:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
            t = time.perf_counter()
            out = builds[name]()
            if on_card:
                torch.cuda.synchronize(device)
            secs[name].append(time.perf_counter() - t)
            if on_card:
                outs = sum(x.numel() * x.element_size() for x in out[:3])
                over = torch.cuda.max_memory_allocated(device) - base - outs
                peak[name] = max(peak[name] or 0, over)
            if first is None:
                first = out
            elif out[3] != first[3] or not all(
                    torch.equal(a, b) for a, b in zip(out[:3], first[:3])):
                raise AssertionError(f"{name}: the runs differ")
            del out
    print(json.dumps({
        "entries": n, "setup_s": setup_s, "order": order, "reps": args.reps,
        "seconds": secs,
        "peak_above_table_and_outputs_gib": {
            k: None if v is None else v / 2**30 for k, v in peak.items()},
        "device": (torch.cuda.get_device_name(0) if on_card else "cpu"),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
