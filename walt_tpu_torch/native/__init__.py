"""Native host library of the port: race-free g++ build + ctypes bindings.

The sources (``finalize.cpp``, ``fastio.cpp``, ``se_exact.cpp``,
``indexbuild.cpp``, ``pq.hpp``) are compiled on first use into
``build/native/libwaltx_native.so`` at the repository root when run from a
checkout, else under ``~/.cache/walt_tpu_torch/native/``, and rebuilt
whenever a source is newer.  Each process compiles into a file of its own
and renames it into place, so processes that start at once (pytest
workers) never load a half-written library: one that finds an up-to-date
library loads it.  Everything degrades gracefully: if no compiler is
available the callers fall back to the (identical, slower) Python
implementations in walt_tpu_torch.host.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "finalize.cpp"), os.path.join(_DIR, "fastio.cpp"),
         os.path.join(_DIR, "se_exact.cpp"), os.path.join(_DIR, "indexbuild.cpp")]
_HDRS = [os.path.join(_DIR, "pq.hpp")]
_ROOT = os.path.dirname(os.path.dirname(_DIR))
# a checkout builds beside its sources; an installed copy must not write
# into site-packages, so it builds in the user's cache
BUILD_DIR = (
    os.path.join(_ROOT, "build", "native")
    if os.path.isfile(os.path.join(_ROOT, "pyproject.toml"))
    else os.path.join(os.path.expanduser("~"), ".cache", "walt_tpu_torch",
                      "native")
)
LIB_NAME = "libwaltx_native.so"

_lib = None
_tried = False
_lock = threading.Lock()


def lib_path() -> str:
    return os.path.join(BUILD_DIR, LIB_NAME)


def _build() -> bool:
    try:
        src_m = max(os.path.getmtime(s) for s in _SRCS + _HDRS)
    except OSError:
        return False
    so = lib_path()
    if os.path.exists(so) and os.path.getmtime(so) >= src_m:
        return True
    # a name of this process's own: concurrent builders never share a file
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp]
            + _SRCS,
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib():
    """The loaded library, or None when unavailable."""
    with _lock:
        return _load()


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(lib_path())
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.pe_finalize.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(i8p), ctypes.POINTER(u32p),
        ctypes.POINTER(i32p), ctypes.POINTER(i32p),
        u8p, i32p, i32p,
        u32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u8p, i32p,
        i32p, u32p, u8p,
        i32p, u32p, u8p,
        u32p, i32p, u8p, i32p,
    ]
    lib.pe_finalize.restype = None
    lib.sort_buckets_mt.argtypes = [
        u8p, u32p, ctypes.c_int32, u32p, ctypes.c_int64, u32p, u32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.sort_buckets_mt.restype = ctypes.c_int32
    lib.csr_count.argtypes = [
        u8p, u32p, ctypes.c_int32, u32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, u32p, ctypes.c_int32,
    ]
    lib.csr_count.restype = ctypes.c_int32
    lib.csr_fill.argtypes = [
        u8p, u32p, ctypes.c_int32, u32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, u32p, ctypes.c_int32, u8p, u32p,
    ]
    lib.csr_fill.restype = None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.count_newlines.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                   i64p]
    lib.count_newlines.restype = ctypes.c_int64
    lib.fastq_scan.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i32p,
    ]
    lib.fastq_scan.restype = ctypes.c_int
    lib.fastq_fill.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        u8p, u8p, i32p, i64p, i32p, i64p, i32p,
    ]
    lib.fastq_fill.restype = None
    lib.mr_emit_batch.argtypes = [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, i64p, i32p, i64p, i32p,
        u8p, ctypes.c_int32, i32p,
        i32p, u8p, i64p, i32p,
        i32p, u8p, i64p, i32p,
        ctypes.c_int,
    ]
    lib.mr_emit_batch.restype = ctypes.c_int
    lib.sam_emit_batch.argtypes = [
        ctypes.c_int64, ctypes.c_int,
        u8p, i64p, i32p, i64p, i32p,
        u8p, ctypes.c_int32, i32p,
        i32p, u8p, i64p, i32p,
        i32p, u8p, i64p, i32p,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.sam_emit_batch.restype = ctypes.c_int
    lib.pe_sam_emit_batch.argtypes = [
        ctypes.c_int64, ctypes.c_int,
        u8p, i64p, i32p, i64p, i32p, u8p, ctypes.c_int32, i32p,
        u8p, i64p, i32p, u8p, ctypes.c_int32, i32p,
        u8p, i32p,
        i32p, i64p, i32p, i32p, u8p,
        i32p, i64p, i32p, i32p, u8p,
        u8p, i64p, i32p,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.pe_sam_emit_batch.restype = ctypes.c_int
    lib.dio_write.argtypes = [ctypes.c_int, u8p, ctypes.c_int64]
    lib.dio_write.restype = ctypes.c_int
    lib.se_exact_batch.argtypes = [
        ctypes.c_int64, u8p, ctypes.c_int32, i32p,
        i32p, i32p,
        u8p, u32p, u32p,
        u8p, u32p, u32p,
        u32p, ctypes.c_int32,
        u32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u32p, i32p, u8p, i32p,
    ]
    lib.se_exact_batch.restype = None
    lib.pe_exact_ranked.argtypes = [
        ctypes.c_int64, u8p, ctypes.c_int32, i32p,
        i32p, i32p,
        u8p, u32p, u32p,
        u8p, u32p, u32p,
        u32p, ctypes.c_int32,
        u32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, u32p, u8p,
    ]
    lib.pe_exact_ranked.restype = None
    lib.pe_join_ranked.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, u32p, u8p,
        i32p, i32p, u32p, u8p,
        i32p, i32p,
        u32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        u8p, i32p,
        i32p, u32p, u8p,
        i32p, u32p, u8p,
        u32p, i32p, u8p, i32p,
    ]
    lib.pe_join_ranked.restype = None
    i64p_ = ctypes.POINTER(ctypes.c_int64)
    lib.pe_emit_batch.argtypes = [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        u8p, i64p_, i32p, i64p_, i32p, u8p, ctypes.c_int32, i32p,
        u8p, i64p_, i32p, u8p, ctypes.c_int32, i32p,
        u8p,
        i32p, i64p_, i64p_, i64p_, i64p_, u8p,
        i32p, i32p, i32p,
        i32p, i64p_, i32p, i32p, u8p,
        i32p, i64p_, i32p, i32p, u8p,
        u8p, i64p_, i32p,
        ctypes.c_int32, ctypes.c_int,
    ]
    lib.pe_emit_batch.restype = ctypes.c_int
    _lib = lib
    return _lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def count_newlines(buf, need: int):
    """(newlines in ``buf`` counted up to ``need``, the offset just past the
    last one counted) by a ``memchr`` walk with the interpreter lock
    released (fastio.cpp), or None when the library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    data = np.frombuffer(buf, dtype=np.uint8)
    end = ctypes.c_int64()
    n = lib.count_newlines(_ptr(data, ctypes.c_uint8), data.shape[0], need,
                           ctypes.byref(end))
    return int(n), int(end.value)


def fastq_parse(buf: bytes, max_reads: int):
    """Native fast-path FASTQ batch parse (fastio.cpp).

    Returns (consumed, codes, seqbytes, slens, name_off, name_len, qual_off,
    qual_len) or None when the buffer needs the exact Python fallback (or
    the library is unavailable).  ``consumed == 0`` with empty arrays means
    an empty buffer.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    data = np.frombuffer(buf, dtype=np.uint8)
    consumed = ctypes.c_int64()
    n_reads = ctypes.c_int64()
    lmax = ctypes.c_int32()
    rc = lib.fastq_scan(
        _ptr(data, ctypes.c_uint8), data.shape[0], max_reads,
        ctypes.byref(consumed), ctypes.byref(n_reads), ctypes.byref(lmax),
    )
    if rc < 0:
        return None
    B, L = int(n_reads.value), int(lmax.value)
    codes = np.empty((B, L), dtype=np.uint8)
    seqbytes = np.empty((B, L), dtype=np.uint8)
    slens = np.empty(B, dtype=np.int32)
    name_off = np.empty(B, dtype=np.int64)
    name_len = np.empty(B, dtype=np.int32)
    qual_off = np.empty(B, dtype=np.int64)
    qual_len = np.empty(B, dtype=np.int32)
    if B:
        lib.fastq_fill(
            _ptr(data, ctypes.c_uint8), consumed.value, B, L,
            _ptr(codes, ctypes.c_uint8), _ptr(seqbytes, ctypes.c_uint8),
            _ptr(slens, ctypes.c_int32),
            _ptr(name_off, ctypes.c_int64), _ptr(name_len, ctypes.c_int32),
            _ptr(qual_off, ctypes.c_int64), _ptr(qual_len, ctypes.c_int32),
        )
    return (int(consumed.value), codes, seqbytes, slens,
            name_off, name_len, qual_off, qual_len)


def mr_emit(fd_main: int, fd_amb: int, fd_unm: int, buf, name_off, name_len,
            qual_off, qual_len, seqbytes, slens, times, minus, starts, mm,
            chr_id, chr_names, chr_off, chr_len, ag_wildcard: bool) -> bool:
    """Native batched MR emission to raw fds (fastio.cpp).  Callers must
    flush Python-level file buffers first.  False when unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    data = np.frombuffer(buf, dtype=np.uint8)
    n, lmax = seqbytes.shape
    rc = lib.mr_emit_batch(
        n, fd_main, fd_amb, fd_unm,
        _ptr(data, ctypes.c_uint8),
        _ptr(name_off, ctypes.c_int64), _ptr(name_len, ctypes.c_int32),
        _ptr(qual_off, ctypes.c_int64), _ptr(qual_len, ctypes.c_int32),
        _ptr(seqbytes, ctypes.c_uint8), lmax, _ptr(slens, ctypes.c_int32),
        _ptr(times, ctypes.c_int32), _ptr(minus, ctypes.c_uint8),
        _ptr(starts, ctypes.c_int64), _ptr(mm, ctypes.c_int32),
        _ptr(chr_id, ctypes.c_int32), _ptr(chr_names, ctypes.c_uint8),
        _ptr(chr_off, ctypes.c_int64), _ptr(chr_len, ctypes.c_int32),
        1 if ag_wildcard else 0,
    )
    return rc == 0


def sam_emit(fd_main: int, buf, name_off, name_len, qual_off, qual_len,
             seqbytes, slens, times, minus, starts, mm, chr_id, chr_names,
             chr_off, chr_len, ambiguous: bool, unmapped: bool) -> bool:
    """Native batched SE SAM emission to the main fd (fastio.cpp).  Callers
    must flush Python-level file buffers first.  False when unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    data = np.frombuffer(buf, dtype=np.uint8)
    n, lmax = seqbytes.shape
    rc = lib.sam_emit_batch(
        n, fd_main,
        _ptr(data, ctypes.c_uint8),
        _ptr(name_off, ctypes.c_int64), _ptr(name_len, ctypes.c_int32),
        _ptr(qual_off, ctypes.c_int64), _ptr(qual_len, ctypes.c_int32),
        _ptr(seqbytes, ctypes.c_uint8), lmax, _ptr(slens, ctypes.c_int32),
        _ptr(times, ctypes.c_int32), _ptr(minus, ctypes.c_uint8),
        _ptr(starts, ctypes.c_int64), _ptr(mm, ctypes.c_int32),
        _ptr(chr_id, ctypes.c_int32), _ptr(chr_names, ctypes.c_uint8),
        _ptr(chr_off, ctypes.c_int64), _ptr(chr_len, ctypes.c_int32),
        1 if ambiguous else 0, 1 if unmapped else 0,
    )
    return rc == 0


def pe_sam_emit(fd_main: int, b1_native, b2_native, len1, len2, code, frag,
                mate1, mate2, chroms, ambiguous: bool,
                unmapped: bool) -> bool:
    """Native batched PE SAM emission (fastio.cpp pe_sam_emit_batch).

    ``b*_native``: (buf, name_off, name_len, qual_off, qual_len, seqbytes)
    from the native FASTQ parse.  ``mate*``: (times, start, chr, mm, minus)
    display arrays; ``chroms``: (blob, off, len).  False when unavailable.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    buf1, noff1, nlen1, qoff1, qlen1, seqb1 = b1_native
    buf2, _, _, qoff2, qlen2, seqb2 = b2_native
    d1 = np.frombuffer(buf1, dtype=np.uint8)
    d2 = np.frombuffer(buf2, dtype=np.uint8)
    n, lmax1 = seqb1.shape
    _, lmax2 = seqb2.shape
    blob, coff, clen = chroms
    t1, s1, c1, m1, mi1 = mate1
    t2, s2, c2, m2, mi2 = mate2
    rc = lib.pe_sam_emit_batch(
        n, fd_main,
        _ptr(d1, ctypes.c_uint8),
        _ptr(noff1, ctypes.c_int64), _ptr(nlen1, ctypes.c_int32),
        _ptr(qoff1, ctypes.c_int64), _ptr(qlen1, ctypes.c_int32),
        _ptr(seqb1, ctypes.c_uint8), lmax1, _ptr(len1, ctypes.c_int32),
        _ptr(d2, ctypes.c_uint8),
        _ptr(qoff2, ctypes.c_int64), _ptr(qlen2, ctypes.c_int32),
        _ptr(seqb2, ctypes.c_uint8), lmax2, _ptr(len2, ctypes.c_int32),
        _ptr(code, ctypes.c_uint8), _ptr(frag, ctypes.c_int32),
        _ptr(t1, ctypes.c_int32), _ptr(s1, ctypes.c_int64),
        _ptr(c1, ctypes.c_int32), _ptr(m1, ctypes.c_int32),
        _ptr(mi1, ctypes.c_uint8),
        _ptr(t2, ctypes.c_int32), _ptr(s2, ctypes.c_int64),
        _ptr(c2, ctypes.c_int32), _ptr(m2, ctypes.c_int32),
        _ptr(mi2, ctypes.c_uint8),
        _ptr(blob, ctypes.c_uint8), _ptr(coff, ctypes.c_int64),
        _ptr(clen, ctypes.c_int32),
        1 if ambiguous else 0, 1 if unmapped else 0,
    )
    return rc == 0


def sort_buckets(seq, chrom_start, counter, index, cared, key_weight,
                 cared_size, nthreads: int = 1):
    """In-place within-bucket std::sort with the reference comparator
    (reference.cpp:258-300); chromosome-end guards run before any character
    access, so no padding is needed.  Large buckets sort on packed comparator
    columns and buckets spread over ``nthreads`` threads -- both
    permutation-identical to the reference's introsort (see finalize.cpp).
    Returns False when the library is unavailable; raises ValueError when
    the cared positions past the key exceed the packed columns' capacity."""
    lib = get_lib()
    if lib is None:
        return False

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    if nthreads <= 0:
        nthreads = max(1, min(8, (os.cpu_count() or 1)))
    rc = lib.sort_buckets_mt(
        ptr(seq, ctypes.c_uint8), ptr(chrom_start, ctypes.c_uint32),
        len(chrom_start) - 1, ptr(counter, ctypes.c_uint32),
        len(counter) - 1, ptr(index, ctypes.c_uint32),
        ptr(cared, ctypes.c_uint32), key_weight, cared_size, nthreads,
    )
    if rc != 0:
        raise ValueError(
            f"sort_buckets: {cared_size - key_weight} cared positions past "
            f"the key exceed the packed comparator's capacity")
    return True


def csr_build(seq, chrom_start, cared, key_weight, min_seed_len,
              extremal, nthreads: int = 1):
    """Counting-sort CSR build (reference.cpp:192-256 as a parallel batch).

    Returns (counter (nb+1,) u32, index (n,) u32, erased_keys (k,) int64) or
    None when the library is unavailable.  O(n) memory -- no key array, no
    argsort temporaries -- and the fill preserves position-ascending order
    within buckets via per-slot base offsets (see indexbuild.cpp).
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    seq = np.ascontiguousarray(seq)
    chrom_start = np.ascontiguousarray(chrom_start.astype(np.uint32))
    cared = np.ascontiguousarray(cared.astype(np.uint32))
    nb = 1 << (2 * key_weight)
    n_chroms = len(chrom_start) - 1
    u32 = ctypes.c_uint32
    n_ranges = lib.csr_count(
        ptr(seq, ctypes.c_uint8), ptr(chrom_start, u32), n_chroms,
        ptr(cared, u32), key_weight, min_seed_len, nthreads, None, 0,
    )
    if n_ranges <= 0:
        return (np.zeros(nb + 1, dtype=np.uint32),
                np.zeros(0, dtype=np.uint32), np.zeros(0, dtype=np.int64),
                np.zeros(0, dtype=np.int64))
    hist = np.zeros((n_ranges, nb), dtype=np.uint32)
    rc = lib.csr_count(
        ptr(seq, ctypes.c_uint8), ptr(chrom_start, u32), n_chroms,
        ptr(cared, u32), key_weight, min_seed_len, nthreads,
        ptr(hist, u32), n_ranges,
    )
    if rc != n_ranges:
        return None
    counts = hist.sum(axis=0, dtype=np.int64)
    erased_keys = np.flatnonzero(counts >= extremal)
    erased_sizes = counts[erased_keys].copy()
    counts[erased_keys] = 0
    counter = np.zeros(nb + 1, dtype=np.uint32)
    counter[1:] = np.cumsum(counts).astype(np.uint32)
    erased = np.zeros(nb, dtype=np.uint8)
    erased[erased_keys] = 1
    # write offset of each (range, key): CSR base + earlier ranges' counts
    base = (np.cumsum(hist, axis=0, dtype=np.int64) - hist
            + counter[:-1][None, :]).astype(np.uint32)
    del hist
    index = np.empty(int(counter[-1]), dtype=np.uint32)
    lib.csr_fill(
        ptr(seq, ctypes.c_uint8), ptr(chrom_start, u32), n_chroms,
        ptr(cared, u32), key_weight, min_seed_len, nthreads,
        ptr(base, u32), n_ranges, ptr(erased, ctypes.c_uint8),
        ptr(index, u32),
    )
    return counter, index, erased_keys, erased_sizes


def _exact_args(codes, lens, tables, ag_wildcard, pattern, nthreads):
    """Shared argument marshalling for the exact enumerator entry points."""
    import numpy as np

    from walt_tpu_torch.core import refmap

    n = codes.shape[0]
    lens = np.ascontiguousarray(lens.astype(np.int32))
    # base code 0 past each read's end, in a row wide enough for every
    # seed's hash key (SeedPattern.key_span): the batch pads with PAD_CODE
    lmax = max(codes.shape[1], pattern.key_span)
    conv = np.zeros((n, lmax), dtype=np.uint8)
    conv[:, : codes.shape[1]] = refmap.convert_read(codes, ag_wildcard)
    conv[np.arange(lmax)[None, :] >= lens[:, None]] = 0
    repeats = np.ascontiguousarray(
        pattern.repeats_for_len(lens).astype(np.int32)
    )
    seed_len = np.ascontiguousarray(
        pattern.seed_len_for_len(lens).astype(np.int32)
    )
    tbl = []
    for g, ht in tables:
        tbl += [refmap.padded_seq(g, pattern),
                np.ascontiguousarray(ht.counter),
                np.ascontiguousarray(ht.index)]
    start = np.ascontiguousarray(tables[0][0].start_index.astype(np.uint32))
    cared = np.ascontiguousarray(pattern.cared.astype(np.uint32))
    skips = np.ascontiguousarray(
        np.asarray([list(t) for t in pattern.verify_skip], dtype=np.int32)
        .reshape(-1)
    )
    if nthreads <= 0:
        nthreads = max(1, min(8, (os.cpu_count() or 1)))
    args = [
        n, _ptr(conv, ctypes.c_uint8), lmax, _ptr(lens, ctypes.c_int32),
        _ptr(repeats, ctypes.c_int32), _ptr(seed_len, ctypes.c_int32),
        _ptr(tbl[0], ctypes.c_uint8), _ptr(tbl[1], ctypes.c_uint32),
        _ptr(tbl[2], ctypes.c_uint32),
        _ptr(tbl[3], ctypes.c_uint8), _ptr(tbl[4], ctypes.c_uint32),
        _ptr(tbl[5], ctypes.c_uint32),
        _ptr(start, ctypes.c_uint32), len(start) - 1,
        _ptr(cared, ctypes.c_uint32), int(pattern.key_weight),
        int(pattern.pattern_len), int(pattern.exit1_seed),
        _ptr(skips, ctypes.c_int32), len(skips) // 3,
    ]
    # the marshalled numpy temporaries must outlive the C call
    keepalive = (conv, lens, repeats, seed_len, tbl, start, cared, skips)
    return n, args, nthreads, keepalive


def se_exact(codes, lens, tables, ag_wildcard: bool, b: int, max_mm: int,
             pattern, nthreads: int = 0):
    """Exact BestMatch for a batch of fallback reads (se_exact.cpp).

    ``tables``: [(genome, HashTable), (genome, HashTable)] '+' table first.
    Returns (pos u32, times i32, minus bool, mm i32) arrays, or None when
    the native library is unavailable.  Byte-equivalent to
    refmap.enumerate_candidates + replay.replay_single per read.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    n, args, nthreads, _keep = _exact_args(
        codes, lens, tables, ag_wildcard, pattern, nthreads
    )
    out_pos = np.empty(n, dtype=np.uint32)
    out_times = np.empty(n, dtype=np.int32)
    out_strand = np.empty(n, dtype=np.uint8)
    out_mm = np.empty(n, dtype=np.int32)
    lib.se_exact_batch(
        *args, int(b), int(max_mm), int(nthreads),
        _ptr(out_pos, ctypes.c_uint32), _ptr(out_times, ctypes.c_int32),
        _ptr(out_strand, ctypes.c_uint8), _ptr(out_mm, ctypes.c_int32),
    )
    return out_pos, out_times, out_strand.astype(bool), out_mm


def pe_exact_ranked(codes, lens, tables, ag_wildcard: bool, b: int,
                    max_mm: int, top_k: int, pattern, nthreads: int = 0):
    """Exact drain-order top-k candidates for fallback reads of one mate.

    Returns (count (n,) i32, mm (n,k) i32, pos (n,k) u32, strand (n,k) u8)
    or None when unavailable.  Byte-equivalent to
    replay.replay_paired_topk over refmap.enumerate_candidates streams.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    n, args, nthreads, _keep = _exact_args(
        codes, lens, tables, ag_wildcard, pattern, nthreads
    )
    out_n = np.empty(n, dtype=np.int32)
    out_mm = np.empty((n, top_k), dtype=np.int32)
    out_pos = np.empty((n, top_k), dtype=np.uint32)
    out_strand = np.empty((n, top_k), dtype=np.uint8)
    lib.pe_exact_ranked(
        *args, int(b), int(max_mm), int(top_k), int(nthreads),
        _ptr(out_n, ctypes.c_int32), _ptr(out_mm, ctypes.c_int32),
        _ptr(out_pos, ctypes.c_uint32), _ptr(out_strand, ctypes.c_uint8),
    )
    return out_n, out_mm, out_pos, out_strand


def pe_join_ranked(ranked1, ranked2, len1, len2, chrom_start, frag_range,
                   max_mm, top_k):
    """Join pre-drained ranked candidate lists of both mates (finalize.cpp).

    ``ranked1/ranked2``: the (cnt, mm, pos, strand) tuples returned by
    :func:`pe_exact_ranked` for each mate.  Returns the same dict layout as
    :func:`pe_finalize`, or None when the library is unavailable.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    cnt1, mm1, pos1, st1 = ranked1
    cnt2, mm2, pos2, st2 = ranked2
    n = cnt1.shape[0]
    out = dict(
        code=np.zeros(n, dtype=np.uint8),
        frag=np.zeros(n, dtype=np.int32),
        r1_mm=np.zeros(n, dtype=np.int32),
        r1_pos=np.zeros(n, dtype=np.uint32),
        r1_strand=np.zeros(n, dtype=np.uint8),
        r2_mm=np.zeros(n, dtype=np.int32),
        r2_pos=np.zeros(n, dtype=np.uint32),
        r2_strand=np.zeros(n, dtype=np.uint8),
        bm_pos=np.zeros(2 * n, dtype=np.uint32),
        bm_times=np.zeros(2 * n, dtype=np.int32),
        bm_strand=np.zeros(2 * n, dtype=np.uint8),
        bm_mm=np.zeros(2 * n, dtype=np.int32),
    )
    len1 = np.ascontiguousarray(len1.astype(np.int32))
    len2 = np.ascontiguousarray(len2.astype(np.int32))
    chrom_start = np.ascontiguousarray(chrom_start)
    lib.pe_join_ranked(
        n, int(top_k),
        _ptr(cnt1, ctypes.c_int32), _ptr(mm1, ctypes.c_int32),
        _ptr(pos1, ctypes.c_uint32), _ptr(st1, ctypes.c_uint8),
        _ptr(cnt2, ctypes.c_int32), _ptr(mm2, ctypes.c_int32),
        _ptr(pos2, ctypes.c_uint32), _ptr(st2, ctypes.c_uint8),
        _ptr(len1, ctypes.c_int32), _ptr(len2, ctypes.c_int32),
        _ptr(chrom_start, ctypes.c_uint32), len(chrom_start) - 1,
        int(frag_range), int(max_mm),
        _ptr(out["code"], ctypes.c_uint8), _ptr(out["frag"], ctypes.c_int32),
        _ptr(out["r1_mm"], ctypes.c_int32), _ptr(out["r1_pos"], ctypes.c_uint32),
        _ptr(out["r1_strand"], ctypes.c_uint8),
        _ptr(out["r2_mm"], ctypes.c_int32), _ptr(out["r2_pos"], ctypes.c_uint32),
        _ptr(out["r2_strand"], ctypes.c_uint8),
        _ptr(out["bm_pos"], ctypes.c_uint32), _ptr(out["bm_times"], ctypes.c_int32),
        _ptr(out["bm_strand"], ctypes.c_uint8), _ptr(out["bm_mm"], ctypes.c_int32),
    )
    return out


def pe_emit(fds, batch1, batch2, lens1, lens2, fin, unique_coords,
            single_coords, chr_blob, frag_range, pbat) -> bool:
    """Native batched PE MR emission (fastio.cpp pe_emit_batch).

    ``fds``: (main, amb1, unm1, amb2, unm2) raw fds, -1 for absent files.
    ``batch1/batch2``: the ``.native`` tuples of the two mate batches.
    ``unique_coords``: (uchr, s1, e1, s2, e2, plus) int64/int32/uint8 arrays.
    ``single_coords``: per mate (times, start, chr, mm, minus).
    ``chr_blob``: (names u8 blob, off i64, len i32).  False when unavailable.
    """
    lib = get_lib()
    if lib is None:
        return False
    buf1, noff1, nlen1, qoff1, qlen1, seqb1 = batch1
    buf2, _, _, qoff2, qlen2, seqb2 = batch2
    import numpy as np

    b1 = np.frombuffer(buf1, dtype=np.uint8)
    b2 = np.frombuffer(buf2, dtype=np.uint8)
    n, lmax1 = seqb1.shape
    lmax2 = seqb2.shape[1]
    uchr, s1, e1, s2, e2, plus = unique_coords
    (t1, st1, c1, m1, mi1), (t2, st2, c2, m2, mi2) = single_coords
    blob, coff, clen = chr_blob
    rc = lib.pe_emit_batch(
        n, *[int(f) for f in fds],
        _ptr(b1, ctypes.c_uint8), _ptr(noff1, ctypes.c_int64),
        _ptr(nlen1, ctypes.c_int32), _ptr(qoff1, ctypes.c_int64),
        _ptr(qlen1, ctypes.c_int32), _ptr(seqb1, ctypes.c_uint8),
        lmax1, _ptr(lens1, ctypes.c_int32),
        _ptr(b2, ctypes.c_uint8), _ptr(qoff2, ctypes.c_int64),
        _ptr(qlen2, ctypes.c_int32), _ptr(seqb2, ctypes.c_uint8),
        lmax2, _ptr(lens2, ctypes.c_int32),
        _ptr(fin["code"], ctypes.c_uint8),
        _ptr(uchr, ctypes.c_int32), _ptr(s1, ctypes.c_int64),
        _ptr(e1, ctypes.c_int64), _ptr(s2, ctypes.c_int64),
        _ptr(e2, ctypes.c_int64), _ptr(plus, ctypes.c_uint8),
        _ptr(fin["r1_mm"], ctypes.c_int32), _ptr(fin["r2_mm"], ctypes.c_int32),
        _ptr(fin["frag"], ctypes.c_int32),
        _ptr(t1, ctypes.c_int32), _ptr(st1, ctypes.c_int64),
        _ptr(c1, ctypes.c_int32), _ptr(m1, ctypes.c_int32),
        _ptr(mi1, ctypes.c_uint8),
        _ptr(t2, ctypes.c_int32), _ptr(st2, ctypes.c_int64),
        _ptr(c2, ctypes.c_int32), _ptr(m2, ctypes.c_int32),
        _ptr(mi2, ctypes.c_uint8),
        _ptr(blob, ctypes.c_uint8), _ptr(coff, ctypes.c_int64),
        _ptr(clen, ctypes.c_int32),
        int(frag_range), 1 if pbat else 0,
    )
    return rc == 0


def pe_finalize(streams, skip, len1, len2, chrom_start, top_k, frag_range,
                max_mm, exit1_seed):
    """Batched paired-end finalization (see finalize.cpp for the contract).

    ``streams``: list of 4 dicts with C-contiguous arrays ``seed`` (n, C)
    int8, ``pos`` (n, C) uint32, ``mm`` (n, C) int32, ``cnt`` (n,) int32 in
    stream order (mate1 '+', mate1 '-', mate2 '+', mate2 '-').

    Returns dict of per-pair result arrays, or None when the native library
    is unavailable.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    n, C = streams[0]["seed"].shape

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)

    seed_arr = (i8p * 4)(*[ptr(s["seed"], ctypes.c_int8) for s in streams])
    pos_arr = (u32p * 4)(*[ptr(s["pos"], ctypes.c_uint32) for s in streams])
    mm_arr = (i32p * 4)(*[ptr(s["mm"], ctypes.c_int32) for s in streams])
    cnt_arr = (i32p * 4)(*[ptr(s["cnt"], ctypes.c_int32) for s in streams])

    out = dict(
        code=np.zeros(n, dtype=np.uint8),
        frag=np.zeros(n, dtype=np.int32),
        r1_mm=np.zeros(n, dtype=np.int32),
        r1_pos=np.zeros(n, dtype=np.uint32),
        r1_strand=np.zeros(n, dtype=np.uint8),
        r2_mm=np.zeros(n, dtype=np.int32),
        r2_pos=np.zeros(n, dtype=np.uint32),
        r2_strand=np.zeros(n, dtype=np.uint8),
        bm_pos=np.zeros(2 * n, dtype=np.uint32),
        bm_times=np.zeros(2 * n, dtype=np.int32),
        bm_strand=np.zeros(2 * n, dtype=np.uint8),
        bm_mm=np.zeros(2 * n, dtype=np.int32),
    )
    lib.pe_finalize(
        n, C, seed_arr, pos_arr, mm_arr, cnt_arr,
        ptr(skip, ctypes.c_uint8), ptr(len1, ctypes.c_int32),
        ptr(len2, ctypes.c_int32), ptr(chrom_start, ctypes.c_uint32),
        len(chrom_start) - 1, top_k, frag_range, max_mm, exit1_seed,
        ptr(out["code"], ctypes.c_uint8), ptr(out["frag"], ctypes.c_int32),
        ptr(out["r1_mm"], ctypes.c_int32), ptr(out["r1_pos"], ctypes.c_uint32),
        ptr(out["r1_strand"], ctypes.c_uint8),
        ptr(out["r2_mm"], ctypes.c_int32), ptr(out["r2_pos"], ctypes.c_uint32),
        ptr(out["r2_strand"], ctypes.c_uint8),
        ptr(out["bm_pos"], ctypes.c_uint32), ptr(out["bm_times"], ctypes.c_int32),
        ptr(out["bm_strand"], ctypes.c_uint8), ptr(out["bm_mm"], ctypes.c_int32),
    )
    return out
