"""Host allocator tuning for page-fault-expensive environments.

glibc serves allocations above the mmap threshold (128 KB default) with a
fresh mmap and unmaps them on free, so every large NumPy temporary is paid
for in page faults.  On virtualized TPU hosts a demand fault on private
anonymous memory can cost ~40 us of VMM round trip (snapshot-restored VMs
serve faults through userfaultfd), i.e. first-touch bandwidth of ~8 MB/s --
measured here: np.ones(100MB) 20-26 s, np.diff over a 16.7M-entry array
30-50 s.  Batch population (MADV_POPULATE_WRITE) runs at ~1 GB/s on the
same host, and already-faulted heap pages are full memory speed.

So the strategy has two halves, both process-global and idempotent:

- :func:`tune_malloc` raises M_MMAP_THRESHOLD and disables trim, so large
  blocks come from (and return to) the brk heap instead of fresh mmaps;
- :func:`prefault` grows the heap once by N bytes and batch-populates it,
  after which every NumPy temporary under that high-water mark is
  fault-free.

Failures (musl, non-Linux, old kernels) are ignored.
"""

from __future__ import annotations

import ctypes
import os
import sys

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_MADV_POPULATE_WRITE = 23

_done = False
_prefaulted = 0


def tune_malloc(mmap_threshold: int = (1 << 31) - 1) -> bool:
    """mallopt(M_MMAP_THRESHOLD, INT_MAX) + mallopt(M_TRIM_THRESHOLD, -1)."""
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, mmap_threshold)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, -1)
        _done = bool(ok1) and bool(ok2)
    except (OSError, AttributeError):
        return False
    return _done


def prefault(n_bytes: int | None = None) -> bool:
    """Grow the heap by ``n_bytes`` and batch-populate it (~1 s/GB once).

    Call before a large host workload (mapping run, index build, bench).
    ``WALTX_PREFAULT_MB`` overrides the default size; 0 disables.  Repeat
    calls only ever extend the populated high-water mark.
    """
    global _prefaulted
    if n_bytes is None:
        n_bytes = int(os.environ.get("WALTX_PREFAULT_MB", "2048")) << 20
    if n_bytes <= _prefaulted or not tune_malloc():
        return n_bytes <= _prefaulted
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.malloc.restype = ctypes.c_void_p
        p = libc.malloc(ctypes.c_size_t(n_bytes))
        if not p:
            return False
        a0 = (p + 4095) & ~4095
        n = max(0, ((p + n_bytes) & ~4095) - a0)
        r = libc.madvise(
            ctypes.c_void_p(a0), ctypes.c_size_t(n), _MADV_POPULATE_WRITE
        )
        libc.free(ctypes.c_void_p(p))
        if r == 0:
            _prefaulted = max(_prefaulted, n_bytes)
        return r == 0
    except (OSError, AttributeError):
        return False
