"""Multi-process runs: process group, input sharding, stats merge.

Port of ``walt_tpu/parallel/multihost.py`` over ``torch.distributed``.  One
process runs per host (or per group of cards); read FILES are data-parallel
round-robin across processes (the mapper's per-file loop, walt.cpp:254-270,
is embarrassingly parallel, and file-granular sharding keeps every output
byte-identical to a single-process run of that file), and each process maps
its files on its own devices.  The process group uses the gloo backend: the
processes exchange nothing but a barrier.

For an input that arrives as one giant FASTQ, split it at record
boundaries and pass the parts as a comma list; ``merge_mapstats`` folds the
per-part ``.mapstats`` files into one, byte-formatted like a single run's.

``shard_round_robin`` and ``merge_mapstats`` are copies of walt_tpu's.
"""

from __future__ import annotations

import os
import re

import torch.distributed as dist


def initialize() -> tuple:
    """Join the process group named by the environment; returns (rank,
    world size).

    ``WALTX_COORDINATOR`` (host:port of rank 0), ``WALTX_NUM_HOSTS`` and
    ``WALTX_HOST_ID`` name the group, as for walt_tpu.  Without
    ``WALTX_COORDINATOR`` the process runs alone: (0, 1).  Idempotent.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = os.environ.get("WALTX_COORDINATOR")
    if not coordinator:
        return 0, 1
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=int(os.environ["WALTX_NUM_HOSTS"]),
        rank=int(os.environ["WALTX_HOST_ID"]),
    )
    return dist.get_rank(), dist.get_world_size()


def shard_round_robin(items: list, pid: int, n: int) -> list:
    """This process's share of a work list (file-granular data parallelism)."""
    return list(items[pid::n])


def barrier() -> None:
    """Block until every process reaches this point (no-op alone)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


_INT_LINE = re.compile(
    r"^(\s*)([a-z_0-9]+): (-?[\d.]+(?:e[+-]?\d+)?|-?nan|-?inf)$")


def _parse_mapstats(text: str) -> list:
    """[(indent, key, value_str)] per line; non-numeric lines kept verbatim."""
    out = []
    for line in text.rstrip("\n").split("\n"):
        m = _INT_LINE.match(line)
        out.append((m.group(1), m.group(2), m.group(3)) if m else line)
    return out


def merge_mapstats(paths: list, out_path: str) -> None:
    """Sum N single-run ``.mapstats`` files into one, byte-formatted the same.

    Counter lines (total_reads, unique, ambiguous, unmapped, too_short,
    frag_len buckets, ...) are summed; derived lines (percent_unique,
    frag_len_mean) are recomputed with the emitters' formatting
    (``emit.fmt_double`` / ``pct``); min_read_length must agree across
    parts.  All parts must be the same shape (all SE or all PE, same
    frag_range).
    """
    from walt_tpu_torch.host.emit import fmt_double, pct

    parsed = []
    for p in paths:
        with open(p) as f:
            parsed.append(_parse_mapstats(f.read()))
    base = parsed[0]
    if any(len(other) != len(base) for other in parsed[1:]):
        raise ValueError("merge_mapstats: the parts differ in shape")

    sums: dict = {}
    for li, item in enumerate(base):
        if not isinstance(item, tuple):
            continue
        key = item[1]
        if key in ("percent_unique", "frag_len_mean"):
            continue
        if key == "min_read_length":
            if len({p[li][2] for p in parsed}) != 1:
                raise ValueError("min_read_length differs between parts")
            continue
        sums[li] = sum(int(p[li][2]) for p in parsed)

    # reconstruct, recomputing the derived lines from the summed section
    lines = []
    ctx: dict = {}
    for li, item in enumerate(base):
        if not isinstance(item, tuple):
            lines.append(item)
            continue
        indent, key, val = item
        if li in sums:
            v = sums[li]
            lines.append(f"{indent}{key}: {v}")
            ctx[key] = v  # last-seen wins; derived lines follow their inputs
            if key.isdigit():  # frag_len histogram bucket
                ctx["_hist_total"] = ctx.get("_hist_total", 0) + v
                ctx["_hist_wsum"] = ctx.get("_hist_wsum", 0) + int(key) * v
        elif key == "percent_unique":
            total = ctx.get("total_reads", ctx.get("total_read_pairs", 0))
            lines.append(
                f"{indent}{key}: {fmt_double(pct(ctx.get('unique', 0), total))}"
            )
        elif key == "frag_len_mean":
            denom = float(ctx.get("_hist_total", 0))
            wsum = float(ctx.get("_hist_wsum", 0))
            if denom != 0:
                mean = wsum / denom
            elif wsum == 0:
                mean = float("nan")
            else:
                mean = float("inf")
            lines.append(f"{indent}{key}: {fmt_double(mean)}")
        else:  # min_read_length (validated identical)
            lines.append(f"{indent}{key}: {val}")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
