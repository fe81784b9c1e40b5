"""Share of the window's pairs that neither mate's
``map_mate_slabs_finish`` flagged for the host, in percent (the driver
finishes mate 1, then mate 2, of each batch)."""

import numpy as np


def read(run):
    fb = run["fb"]
    if run["mode"] != "pe" or not fb or len(fb) % 2:
        return None
    both = [a | b for a, b in zip(fb[0::2], fb[1::2])]
    return 100.0 * float((~np.concatenate(both)).mean())
