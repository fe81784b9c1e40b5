"""The load spread over a tp mesh's shards: the largest of the
``mesh.flat_rows.<t>`` counters (flat candidate entries the PE decode took
from shard t's stream) over their mean.  1 is an even split; bucket-range
shards of converted keys are uneven (F4).  Nothing where the program keeps
no such counters (one card, or a program without them)."""


def read(run):
    if run["mode"] != "pe":
        return None
    from walt_tpu_torch import perf

    if not hasattr(perf, "counters"):
        return None
    rows = [v for k, v in perf.counters().items()
            if k.startswith("mesh.flat_rows.")]
    if not rows or not sum(rows):
        return None
    return max(rows) / (sum(rows) / len(rows))
