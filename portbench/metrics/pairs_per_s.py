"""Pairs fed to the PE driver in the window over the window's whole time."""


def read(run):
    if run["mode"] != "pe":
        return None
    return run["n"] / run["window_s"]
