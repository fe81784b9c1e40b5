"""The backend's ``backend.decode.merge`` spans (on a tp mesh, the host's
seed-order merge of the shards' flat streams inside ``backend.decode``:
their concatenation, one lexsort and the slab writes), in seconds per
million pairs fed.  Nothing where the program keeps no such span (one
card, or a program without it)."""


def read(run):
    s = run["spans"].get("backend.decode.merge")
    if run["mode"] != "pe" or s is None or not run["n"]:
        return None
    return s / (run["n"] / 1e6)
