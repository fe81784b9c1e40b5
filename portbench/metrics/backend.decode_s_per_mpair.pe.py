"""The backend's ``backend.decode`` spans (the mate step's flat candidate
streams decoded into per-strand slabs on the host), in seconds per million
pairs fed."""


def read(run):
    s = run["spans"].get("backend.decode")
    if run["mode"] != "pe" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
