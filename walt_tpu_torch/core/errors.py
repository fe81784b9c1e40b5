"""Device-failure classification shared by the drivers and backends.

The reference fails hard on any error (walt.cpp:274-281).  The device
drivers instead DEGRADE on out-of-memory: a batch whose device program (or
table upload) exhausts HBM is remapped entirely on the exact host path, so
output stays byte-identical and the run completes (round-2 verdict next #9).
"""

from __future__ import annotations

#: batches each driver ("se", "pe") has mapped on the exact host path after
#: a device out-of-memory error, in this process: output stays identical,
#: so a run that must show the device did its work checks these
degraded_batches = {"se": 0, "pe": 0}


class HbmBudgetError(RuntimeError):
    """A device table cannot fit the HBM budget even fully degraded."""


def is_oom_error(e: BaseException) -> bool:
    """True for HBM exhaustion: budget-model rejections and runtime OOMs."""
    if isinstance(e, HbmBudgetError):
        return True
    s = str(e)
    return "RESOURCE_EXHAUSTED" in s or "Out of memory" in s
