"""The PE driver's ``native_finalize`` span (heap replay and pair join of
the device's candidate slabs), in seconds per million pairs fed."""


def read(run):
    s = run["spans"].get("native_finalize")
    if run["mode"] != "pe" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
