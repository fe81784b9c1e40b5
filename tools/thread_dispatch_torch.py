"""Host dispatch of small torch ops from several threads of one process.

A mesh's dp rows each run on a host thread (``parallel.sharded.Mesh
.run_rows``), and each row's SE step is about a thousand small ops whose
Python half needs the interpreter lock, which torch lets go inside every
op.  This measures what dispatch from several threads costs: the wall
time per op of K threads that each issue ``OPS`` small ops (``torch.add``
on a 16-element tensor, a fresh output each time, as the pipeline's ops
allocate theirs), against one thread that issues all K * ``OPS``, for
K = 1, 2, 4 and 8, best of ``REPS``:

- ``"cpu"``: CPU tensors (the interpreter lock alone, no CUDA);
- ``"one card"``: every thread's ops on the first card (a virtual mesh);
- ``"cards"``: thread i's ops on card i % cards (a real mesh), with two or
  more cards.

Usage, from the repository root:

    python tools/thread_dispatch_torch.py [--device cuda|cpu]

One JSON line per row ``{"where", "threads", "us_per_op",
"one_thread_us_per_op"}``; the last line is ``{"results", "cards",
"card"}``.  Nothing is written.  ``--device cpu`` runs the CPU rows only;
there is no fallback from the card to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OPS = 20_000
REPS = 3
THREADS = (1, 2, 4, 8)


def run(devices, ops: int) -> float:
    """Seconds for one thread per device in ``devices`` to issue ``ops``
    ops each, every card synchronized at the end."""
    import torch

    xs = [torch.zeros(16, device=d) for d in devices]
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    for d in cards:
        torch.cuda.synchronize(d)
    start = threading.Barrier(len(devices) + 1)

    def issue(x):
        if x.device.type == "cuda":
            torch.cuda.set_device(x.device)
        start.wait()
        for _ in range(ops):
            torch.add(x, 1)

    threads = [threading.Thread(target=issue, args=(x,)) for x in xs]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    for d in cards:
        torch.cuda.synchronize(d)
    return time.perf_counter() - t0


def row(where: str, devices) -> dict:
    k = len(devices)
    many = min(run(devices, OPS) for _ in range(REPS))
    one = min(run(devices[:1], k * OPS) for _ in range(REPS))
    out = dict(where=where, threads=k, us_per_op=many / (k * OPS) * 1e6,
               one_thread_us_per_op=one / (k * OPS) * 1e6)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    import torch

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        p.exit(1, f"{p.prog}: no CUDA device (use --device cpu)\n")
    layouts = [("cpu", lambda k: [torch.device("cpu")] * k)]
    if on_card:
        n = torch.cuda.device_count()
        layouts.append(("one card", lambda k: [torch.device("cuda", 0)] * k))
        if n >= 2:
            layouts.append(("cards", lambda k: [torch.device("cuda", i % n)
                                                for i in range(k)]))
    results = [row(where, devices(k)) for where, devices in layouts
               for k in THREADS]
    import chip_smoke as cs

    print(json.dumps({
        "results": results, "cards": torch.cuda.device_count() if on_card
        else 0, "card": cs.card_lines() if on_card else "cpu only"}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
