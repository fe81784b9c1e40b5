"""Reads fed to the SE driver in the window, too short and unmapped
included, over the window's whole time."""


def read(run):
    if run["mode"] != "se":
        return None
    return run["n"] / run["window_s"]
