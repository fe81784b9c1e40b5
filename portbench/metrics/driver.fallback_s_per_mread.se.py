"""The SE driver's ``host_fallback`` span (``native.se_exact`` on the reads
the device flagged), in seconds per million reads fed."""


def read(run):
    s = run["spans"].get("host_fallback")
    if run["mode"] != "se" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
