"""File-like append writer that bypasses slow page-cache writeback.

On the virtualized TPU host class, buffered writeback degrades to ~4 MB/s
as dirty memory grows, while O_DIRECT sustains ~100 MB/s (see
native/fastio.cpp:direct_write).  DirectFile batches text writes in memory
and flushes >=4 MB blocks through the native O_DIRECT writer (falling back
to plain os.write when the library is unavailable).  It implements the
file-object surface the drivers and the resume checkpointing use: write,
writelines, flush, tell, seek, truncate, fileno, close.
"""

from __future__ import annotations

import os

_FLUSH_AT = 4 << 20


class DirectFile:
    def __init__(self, path: str, mode: str = "a"):
        assert mode in ("a", "w")
        flags = os.O_WRONLY | os.O_CREAT | (os.O_TRUNC if mode == "w" else 0)
        self._fd = os.open(path, flags, 0o644)
        os.lseek(self._fd, 0, os.SEEK_END)
        self._parts: list = []
        self._n = 0
        self.closed = False

    def write(self, s) -> int:
        b = s.encode() if isinstance(s, str) else s
        self._parts.append(b)
        self._n += len(b)
        if self._n >= _FLUSH_AT:
            self.flush()
        return len(b)

    def writelines(self, it) -> None:
        for s in it:
            self.write(s)

    def flush(self) -> None:
        if not self._n:
            return
        data = b"".join(self._parts)
        self._parts = []
        self._n = 0
        from walt_tpu_torch import native

        lib = native.get_lib()
        if lib is not None:
            import ctypes

            import numpy as np

            arr = np.frombuffer(data, dtype=np.uint8)
            if lib.dio_write(
                self._fd, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                arr.shape[0],
            ) == 0:
                return
        off = 0
        while off < len(data):
            off += os.write(self._fd, data[off:off + _FLUSH_AT])

    def tell(self) -> int:
        self.flush()
        return os.lseek(self._fd, 0, os.SEEK_CUR)

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        self.flush()
        return os.lseek(self._fd, offset, whence)

    def truncate(self, size: int | None = None) -> int:
        self.flush()
        cur = os.lseek(self._fd, 0, os.SEEK_CUR)
        if size is None:
            size = cur
        os.ftruncate(self._fd, size)
        # the fd is not O_APPEND (O_DIRECT needs explicit offsets), so clamp
        # the position: writing from a stale offset past the new EOF would
        # NUL-fill the gap where append-mode files restart at the end
        if cur > size:
            os.lseek(self._fd, size, os.SEEK_SET)
        return size

    def fileno(self) -> int:
        return self._fd

    def close(self) -> None:
        if not self.closed:
            self.flush()
            os.close(self._fd)
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
