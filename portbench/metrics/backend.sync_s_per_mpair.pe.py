"""The backend's ``backend.sync`` spans (the mapper thread blocked on the
card and the copies back), in seconds per million pairs fed."""


def read(run):
    s = run["spans"].get("backend.sync")
    if run["mode"] != "pe" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
