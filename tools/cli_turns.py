"""Time the port's SE and PE CLI of two trees in turns, on one card.

Host clocks on a shared machine spread 10-30% from one call to the next,
so two versions of the port are compared inside one call: each tree runs
``python -m walt_tpu_torch.cli`` on ``chip_smoke.py``'s data (1M x 100 bp
reads and 500k pairs on its 128 Mbp genome; built first when missing) in
the order A, B, B, A, as a user would run it (one process per run, tables
included).  Each tree builds its kernels and native library before its
first timed run.  The outputs of every run must be byte-identical.

Run from the repository root, on the card, with a second tree unpacked by
``git archive`` into a directory that ``.gitignore`` lists::

    python tools/cli_turns.py build/other_tree .

Prints the card's name and power limit, then one JSON line: the wall time
and the rate of every run, by tree.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit("usage: cli_turns.py TREE_A TREE_B")
    trees = [os.path.abspath(t) for t in argv]

    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    index, fastq, pe = chip_smoke.build_data(
        chip_smoke.DATA, chip_smoke.GENOME_BASES, chip_smoke.N_READS,
        chip_smoke.N_PAIRS, chip_smoke.READ_LEN)
    work = os.path.join(chip_smoke.DATA, "turns")
    os.makedirs(work, exist_ok=True)
    for tree in trees:
        subprocess.run(
            [sys.executable, "-c", "from walt_tpu_torch import kernels, "
             "native; kernels.build(); kernels.library(); native.get_lib()"],
            cwd=tree, check=True, timeout=900)

    runs = {"se": (["-r", fastq], chip_smoke.N_READS, "reads/s"),
            "pe": (["-1", pe[0], "-2", pe[1]], chip_smoke.N_PAIRS, "pairs/s")}
    out = {t: {k: [] for k in runs} for t in argv}
    ref = {}
    for name, tree in zip(argv + argv[::-1], trees + trees[::-1]):
        for mode, (inputs, n, unit) in runs.items():
            mr = os.path.join(work, f"{mode}.mr")
            t = time.perf_counter()
            subprocess.run([sys.executable, "-m", "walt_tpu_torch.cli",
                            "-i", index, *inputs, "-o", mr], cwd=tree,
                           check=True, timeout=900, capture_output=True)
            wall = time.perf_counter() - t
            out[name][mode].append({"wall_s": wall, unit: n / wall})
            got = [open(mr + s, "rb").read() for s in ("", ".mapstats")]
            if ref.setdefault(mode, got) != got:
                raise AssertionError(f"{name} {mode}: output differs")
    print(json.dumps({"order": argv + argv[::-1], "runs": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
