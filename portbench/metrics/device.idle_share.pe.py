"""Share of the traced window in which no operation ran on the card, in
percent (PE cells)."""


def read(run):
    tr = run["trace"]
    if run["mode"] != "pe" or tr is None or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
