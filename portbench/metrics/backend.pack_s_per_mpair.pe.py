"""The backend's ``backend.pack`` spans (2-bit packing of each mate's
reads on the host), in seconds per million pairs fed."""


def read(run):
    s = run["spans"].get("backend.pack")
    if run["mode"] != "pe" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
