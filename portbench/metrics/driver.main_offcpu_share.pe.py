"""Share of the PE driver's main-thread ``host_parse`` and ``host_emit``
wall time in which the thread was not running (waiting for the interpreter
lock, the disk or the scheduler), in percent: 100 x (1 - thread CPU time /
wall time) over the window's records of ``walt_tpu_torch.perf``."""

NAMES = ("host_parse", "host_emit")


def read(run):
    if run["mode"] != "pe":
        return None
    from walt_tpu_torch import perf

    if not hasattr(perf, "spans"):
        return None
    wall = cpu = 0
    for name, _, _, s0, s1, c, _ in perf.spans():
        if name in NAMES:
            wall += s1 - s0
            cpu += c
    if not wall or cpu <= 0:
        return None
    return 100.0 * (1.0 - cpu / wall)
