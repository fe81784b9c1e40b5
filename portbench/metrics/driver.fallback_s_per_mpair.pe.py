"""The PE driver's ``host_fallback`` span (the exact host PE path for the
pairs either mate of which the device flagged), in seconds per million
pairs fed."""


def read(run):
    s = run["spans"].get("host_fallback")
    if run["mode"] != "pe" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
