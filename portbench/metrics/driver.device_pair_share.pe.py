"""Share of the window's pairs that the PE driver finished without the
exact host path, in percent, from its counters (``driver.pairs`` handed to
``pe_finalize``, ``driver.pairs_host`` with either mate flagged)."""


def read(run):
    if run["mode"] != "pe":
        return None
    from walt_tpu_torch import perf

    if not hasattr(perf, "counters"):
        return None
    got = perf.counters()
    pairs = got.get("driver.pairs", 0)
    if not pairs:
        return None
    return 100.0 * ((pairs - got.get("driver.pairs_host", 0)) / pairs)
