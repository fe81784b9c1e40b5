"""Median time of one PE batch through the driver, in seconds: per batch
id of the window's ``walt_tpu_torch.perf`` records, from the start of its
first span (``host_parse``) to the end of its last (``host_emit``), over the
batches that have both."""

import statistics


def read(run):
    if run["mode"] != "pe":
        return None
    from walt_tpu_torch import perf

    if not hasattr(perf, "spans"):
        return None
    first, last, names = {}, {}, {}
    for name, batch, _, s0, s1, _, _ in perf.spans():
        if batch is None:
            continue
        first[batch] = min(first.get(batch, s0), s0)
        last[batch] = max(last.get(batch, s1), s1)
        names.setdefault(batch, set()).add(name)
    full = [b for b, n in names.items() if {"host_parse", "host_emit"} <= n]
    if not full:
        return None
    return statistics.median((last[b] - first[b]) / 1e9 for b in full)
