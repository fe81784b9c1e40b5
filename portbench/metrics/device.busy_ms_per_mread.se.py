"""Milliseconds in which an operation ran on the card, over the traced
window, per million reads fed."""


def read(run):
    tr = run["trace"]
    if run["mode"] != "se" or tr is None or not tr["busy_s"] or not run["n"]:
        return None
    return tr["busy_s"] * 1e3 / (run["n"] / 1e6)
