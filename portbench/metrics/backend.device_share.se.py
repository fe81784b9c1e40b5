"""Share of the window's reads whose fallback flag ``map_single_end`` left
clear: the reads the device resolved, in percent, from the backend's
counters (``backend.reads``, ``backend.fallback_reads``)."""


def read(run):
    if run["mode"] != "se":
        return None
    from walt_tpu_torch import perf

    if not hasattr(perf, "counters"):
        return None
    got = perf.counters()
    reads = got.get("backend.reads", 0)
    if not reads:
        return None
    return 100.0 * ((reads - got.get("backend.fallback_reads", 0)) / reads)
