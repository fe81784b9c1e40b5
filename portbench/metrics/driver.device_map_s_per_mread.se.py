"""The SE driver's ``device_map`` span (packing plus the backend call), in
seconds per million reads fed."""


def read(run):
    s = run["spans"].get("device_map")
    if run["mode"] != "se" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
