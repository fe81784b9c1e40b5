"""Device steps captured as new CUDA graphs inside the window (the
``graphs.captures`` counter of ``walt_tpu_torch.perf``): each one is a step
built again where it should have been replayed."""


def read(run):
    if run["mode"] != "pe":
        return None
    from walt_tpu_torch import perf

    if not hasattr(perf, "counters"):
        return None
    return float(perf.counters().get("graphs.captures", 0))
