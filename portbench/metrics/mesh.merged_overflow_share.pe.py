"""The share of the window's mates that fall back only because their tp
shards' merged entries overflow the candidate slab on a strand, no shard
having flagged them, in percent: ``mesh.merged_overflow_reads`` over
``backend.reads``.  Nothing where the program keeps no such counter."""


def read(run):
    if run["mode"] != "pe":
        return None
    from walt_tpu_torch import perf

    if not hasattr(perf, "counters"):
        return None
    got = perf.counters()
    reads = got.get("backend.reads", 0)
    if "mesh.merged_overflow_reads" not in got or not reads:
        return None
    return 100.0 * got["mesh.merged_overflow_reads"] / reads
