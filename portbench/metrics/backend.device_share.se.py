"""Share of the window's reads whose fallback flag ``map_single_end`` left
clear: the reads the device resolved, in percent."""

import numpy as np


def read(run):
    if run["mode"] != "se" or not run["fb"]:
        return None
    return 100.0 * float((~np.concatenate(run["fb"])).mean())
