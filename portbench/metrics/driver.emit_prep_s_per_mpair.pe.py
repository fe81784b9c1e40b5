"""The PE driver's ``host_emit.prep`` spans (the NumPy preparation of the
batch emission, before the native formatter), in seconds per million pairs
fed."""


def read(run):
    s = run["spans"].get("host_emit.prep")
    if run["mode"] != "pe" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
