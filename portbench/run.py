#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on this machine's cards.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  ``BENCHMARK.json`` names the cells.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checked``: each number the output check compared,
beside its limit.  An earlier ``portbench-info`` line gives the run's
set-up and window, the bytes it wrote and its peak resident memory; the
last lines of standard error repeat the compared numbers.  A run exits
non-zero, and prints no result, without a CUDA card (or with fewer than
the cell asks for), when the configuration's ``tp`` does not divide the
cell's cards, without the program beside it, or when ``jax``, ``jaxlib``,
``flax`` or ``walt_tpu`` is loaded in its process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fail(msg: str, code: int):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def io_counters() -> dict:
    """This process's write counters (/proc/self/io) and peak resident
    memory; the builds' compiler processes are not included."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k in ("wchar", "write_bytes"):
                    out[k] = int(v)
    except OSError:
        pass
    out["peak_rss_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    return out


def card_query() -> tuple:
    """(the first card's name and power limit, its PCI bus id), as
    nvidia-smi gives them."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,pci.bus_id",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        first = got.stdout.strip().splitlines()[0] if got.stdout else ""
    except (OSError, subprocess.SubprocessError):
        first = ""
    name, _, bus = first.rpartition(",")
    return (name.strip(), bus.strip()) if name else (first, None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache = os.path.join(ROOT, "portbench", "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    from portbench import harness, hostinfo

    spec = harness.load_spec(ROOT)
    cell = next((w for w in spec["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs only on the card", 3)
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{torch.cuda.device_count()} CUDA device(s), the cell asks "
             f"for {cell['chips']}", 3)
    try:
        import walt_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program (walt_tpu_torch) is not beside the benchmark: "
             f"{e}", 4)

    try:
        result, info = harness.run_cell(ROOT, args.workload, args.seed,
                                        args.seconds, bool(args.trace),
                                        "cuda", T_START)
    except harness.Refusal as e:
        fail(str(e), 3)
    bad = harness.forbidden_modules()
    if bad:
        fail(f"modules that must not load in a run were loaded: {bad}", 5)
    card, bus_id = card_query()
    result["device"]["card"] = card
    info.update(io_counters(), card=card)
    info["placement"].update(hostinfo.card_sysfs(bus_id))
    print("portbench-info " + json.dumps(info), flush=True)
    for c in result["checked"]:
        print(f"checked {c['name']} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
