"""The share of the window's mates that one tp shard flags for the exact
host path, in percent: the largest of the ``mesh.fallback_reads.<t>``
counters (mates whose fallback bit shard t set: its own slab or flat
stream overflowed) over ``backend.reads`` (mates the backend mapped).
Nothing where the program keeps no such counters."""


def read(run):
    if run["mode"] != "pe":
        return None
    from walt_tpu_torch import perf

    if not hasattr(perf, "counters"):
        return None
    got = perf.counters()
    shards = [v for k, v in got.items()
              if k.startswith("mesh.fallback_reads.")]
    reads = got.get("backend.reads", 0)
    if not shards or not reads:
        return None
    return 100.0 * max(shards) / reads
