"""The PE driver's ``map_wait`` spans (the main thread blocked on the
mapper thread's result), in seconds per million pairs fed."""


def read(run):
    s = run["spans"].get("map_wait")
    if run["mode"] != "pe" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
