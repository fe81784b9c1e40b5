"""Batched FASTQ loading with reference-identical byte semantics.

Reproduces ``LoadReadsFromFastqFile`` (``src/walt/mapping.cpp:65-121``)
including its quirks, because every one of them is observable in the output:

- lines are read with ``fgets`` into a 1000-byte buffer, so physical lines
  longer than 999 bytes are split into multiple logical lines;
- exactly one trailing character is stripped from each logical line (the
  newline -- or a data byte when the line was split or the file does not end
  with a newline);
- empty logical lines are skipped without advancing the 4-line cadence;
- the read name is the line minus its first byte, truncated at the first
  space (mapping.cpp:87-94);
- the adaptor, when given, is clipped by an N-fill *before* non-ACGT
  randomization, so clipped tails turn into random bases
  (mapping.cpp:96-104, util.hpp:202-217);
- non-ACGT bytes (including lower-case bases!) become ``rand() % 4`` with the
  stream reseeded ``srand(0)`` per batch (mapping.cpp:73, util.hpp:156-163).
"""

from __future__ import annotations

import numpy as np

from walt_tpu_torch import native, perf
from walt_tpu_torch.constants import BASE_TO_CODE, CODE_TO_BASE, MAX_LINE_LENGTH, PAD_CODE
from walt_tpu_torch.glibc_rand import GlibcRand

_HEAD_LENGTH = 14  # util.hpp:189
_SUFFICIENT_HEAD_MATCH = 11  # util.hpp:190
_MIN_OVERLAP = 5  # util.hpp:191
_MIN_READ = 1 << 12  # the least FgetsLines.fill asks the stream for
#: the most FgetsLines.fill asks the stream for at once: a file's read(n)
#: allocates n bytes first, and a caller may ask for more lines than the
#: file holds (1 << 40 reads: "to the end")
_MAX_READ = 1 << 28


def _newlines(buf, need: int):
    """(newlines in ``buf`` counted up to ``need``, the offset just past the
    last one counted): the native ``memchr`` walk, else NumPy."""
    got = native.count_newlines(buf, need)
    if got is None:
        nl = np.flatnonzero(np.frombuffer(buf, dtype=np.uint8) == 10)[:need]
        got = (nl.size, int(nl[-1]) + 1 if nl.size else 0)
    return got


class FgetsLines:
    """Iterates logical lines exactly like fgets(buf, 1000, f)."""

    def __init__(self, path_or_file):
        if hasattr(path_or_file, "read"):
            self._f = path_or_file
        else:
            self._f = open(path_or_file, "rb")
        self._buf = b""
        self._line_bytes = 0.0  # mean line length of the lines counted

    def close(self):
        self._f.close()

    def fill(self, n_lines: int) -> int:
        """Buffer input until ``n_lines`` newlines are available (or EOF).

        Returns the newlines buffered, counted up to ``n_lines`` (fewer only
        at EOF).  Consumes nothing; next_line() continues to work on the
        buffer.  Linear in the batch's bytes: the stream is asked for the
        rest of the batch at once (sized by the mean line length seen so
        far), newlines are counted outside the interpreter, and the leftover
        and the chunks are joined once into a fresh ``bytes`` buffer, which
        the batch parsed from it keeps.  Counters: ``parse.stream_bytes``
        (read from the stream) and ``parse.buffer_bytes`` (written into
        parse buffers: each new buffer, each leftover take_buffer carries).
        """
        count, through = _newlines(self._buf, n_lines)
        if count >= n_lines:
            return count
        pieces = [self._buf] if self._buf else []
        size = len(self._buf)
        while count < n_lines:
            per_line = through / count if count else self._line_bytes
            want = min(_MAX_READ, max(_MIN_READ, int(
                (n_lines - count) * per_line * 17 / 16)))
            chunk = self._f.read(want)
            if not chunk:
                break
            got, end = _newlines(chunk, n_lines - count)
            if got:
                count, through = count + got, size + end
            pieces.append(chunk)
            size += len(chunk)
        if count:
            self._line_bytes = through / count
        if size > len(self._buf):
            perf.count("parse.stream_bytes", size - len(self._buf))
            self._buf = b"".join(pieces)
            perf.count("parse.buffer_bytes", size)
        return count

    def take_buffer(self, n_bytes: int) -> None:
        """Drop the first n_bytes of the buffer (fast path consumed them).

        The leftover moves to a buffer of its own; the consumed one is left
        unchanged to the batch that holds it."""
        if n_bytes:
            self._buf = self._buf[n_bytes:]
            perf.count("parse.buffer_bytes", len(self._buf))

    def next_line(self):
        """One fgets call: up to MAX_LINE_LENGTH-1 bytes, through a newline.

        Returns None at EOF.
        """
        limit = MAX_LINE_LENGTH - 1
        while True:
            nl = self._buf.find(b"\n", 0, limit)
            if nl >= 0:
                line, self._buf = self._buf[: nl + 1], self._buf[nl + 1 :]
                return line
            if len(self._buf) >= limit:
                line, self._buf = self._buf[:limit], self._buf[limit:]
                return line
            chunk = self._f.read(65536)
            perf.count("parse.stream_bytes", len(chunk))
            if not chunk:
                if self._buf:
                    line, self._buf = self._buf, b""
                    return line
                return None
            self._buf += chunk


def clip_adaptor(seq: bytearray, adaptor: bytes) -> None:
    """clip_adaptor_from_read (util.hpp:202-217): N-fill the 3' tail in place.

    For reads shorter than the 14-byte head window the reference underflows a
    size_t and scans out of bounds (undefined); we treat such reads as
    unclippable.
    """
    n = len(seq)
    if n < _HEAD_LENGTH:
        return

    def similarity(pos: int) -> int:
        lim = min(n - pos, len(adaptor), _HEAD_LENGTH)
        return sum(seq[pos + i] == adaptor[i] for i in range(lim))

    lim1 = n - _HEAD_LENGTH + 1
    for i in range(lim1):
        if similarity(i) >= _SUFFICIENT_HEAD_MATCH:
            seq[i:] = b"N" * (n - i)
            return
    for i in range(lim1, n - _MIN_OVERLAP + 1):
        if similarity(i) >= n - i - 1:
            seq[i:] = b"N" * (n - i)
            return


class ReadBatch:
    """One loaded batch; names/seqs/quals materialize lazily.

    The native loader (walt_tpu_torch.native.fastio) produces offset arrays into
    the raw buffer plus a decoded base matrix; the Python object lists are
    only built when a consumer actually subscripts them (host-fallback
    reads, the slow emit paths), so the common device path never runs a
    per-read interpreter loop.
    """

    def __init__(self, names=None, seqs=None, quals=None,
                 _codes=None, _lens=None, _native=None):
        self._names = names
        self._seqs = seqs
        self._quals = quals
        self._codes = _codes  # precomputed by the fast loaders
        self._lens = _lens
        #: (buf, name_off, name_len, qual_off, qual_len, seqbytes) or None
        self.native = _native

    def __len__(self):
        if self._lens is not None:
            return len(self._lens)
        return len(self._names)

    @property
    def names(self):
        if self._names is None:
            buf, noff, nlen, _, _, _ = self.native
            no, nl = noff.tolist(), nlen.tolist()
            self._names = [
                buf[no[i]: no[i] + nl[i]].decode() for i in range(len(no))
            ]
        return self._names

    @property
    def seqs(self):
        if self._seqs is None:
            sb = self.native[5]
            flat = sb.tobytes()
            L = sb.shape[1]
            sl = self._lens.tolist()
            self._seqs = [flat[i * L: i * L + sl[i]] for i in range(len(sl))]
        return self._seqs

    @property
    def quals(self):
        if self._quals is None:
            buf, _, _, qoff, qlen, _ = self.native
            qo, ql = qoff.tolist(), qlen.tolist()
            self._quals = [
                buf[qo[i]: qo[i] + ql[i]] for i in range(len(qo))
            ]
        return self._quals

    def lengths(self) -> np.ndarray:
        if self._lens is not None:
            return self._lens
        return np.array([len(s) for s in self.seqs], dtype=np.int32)

    def packed(self, pad_to: int | None = None):
        """(codes uint8 (B, Lmax) PAD_CODE-padded, lengths int32 (B,))."""
        if self._codes is not None and (
            pad_to is None or pad_to == self._codes.shape[1]
        ):
            return self._codes, self._lens
        lens = np.array([len(s) for s in self.seqs], dtype=np.int32)
        lmax = int(pad_to or (lens.max() if len(lens) else 0))
        codes = np.full((len(self.seqs), lmax), PAD_CODE, dtype=np.uint8)
        for i, s in enumerate(self.seqs):
            codes[i, : len(s)] = BASE_TO_CODE[np.frombuffer(s, dtype=np.uint8)]
        return codes, lens


def load_batch(lines: FgetsLines, n_reads: int, adaptor: bytes = b"") -> ReadBatch:
    """One batch of up to n_reads records (mapping.cpp:65-121).

    Regular input (no adaptor clipping, no empty/over-999-byte lines) takes
    a NumPy-vectorized path; anything irregular falls back to the exact
    line-by-line loop.  Both produce identical batches.
    """
    if not adaptor:
        fast = _load_batch_native(lines, n_reads)
        if fast is None:
            fast = _load_batch_fast(lines, n_reads)
        if fast is not None:
            return fast
    return _load_batch_slow(lines, n_reads, adaptor)


def _load_batch_native(lines: FgetsLines, n_reads: int):
    """Native single-pass parse (walt_tpu_torch.native.fastio); None -> fall
    back.  Spans: ``host_parse.fill`` (the stream reads, the newline count,
    the buffer's join and the leftover's carry) and ``host_parse.native``
    (the parse and the batch)."""
    if native.get_lib() is None:
        return None
    with perf.stage("host_parse.fill"):
        lines.fill(4 * n_reads)
    buf = lines._buf
    if not buf:
        return ReadBatch(names=[], seqs=[], quals=[])
    with perf.stage("host_parse.native"):
        parsed = native.fastq_parse(buf, n_reads)
        if parsed is None:
            return None
        consumed, codes, seqbytes, slens, noff, nlen, qoff, qlen = parsed
        if consumed == 0:
            return ReadBatch(names=[], seqs=[], quals=[])
        batch = ReadBatch(
            _codes=codes, _lens=slens,
            _native=(buf, noff, nlen, qoff, qlen, seqbytes),
        )
    with perf.stage("host_parse.fill"):
        lines.take_buffer(consumed)
    return batch


def _load_batch_fast(lines: FgetsLines, n_reads: int):
    n_nl = lines.fill(4 * n_reads)
    if n_nl == 0 and not lines._buf:
        return ReadBatch(names=[], seqs=[], quals=[])
    data = np.frombuffer(lines._buf, dtype=np.uint8)
    nl = np.flatnonzero(data == 10)[: 4 * n_reads]
    if nl.size < 4 * n_reads:
        # EOF tail: a final unterminated line still counts (fgets returns it)
        if nl.size == 0 or int(nl[-1]) != data.shape[0] - 1:
            return None  # oddball EOF handling -> exact slow path
    if nl.size % 4 or nl.size == 0:
        return None
    starts = np.empty(nl.size, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    lens = nl - starts  # content length (newline stripped)
    if int(lens.min()) == 0 or int((nl - starts).max()) > MAX_LINE_LENGTH - 2:
        return None  # empty or fgets-split lines -> exact slow path
    buf = lines._buf

    name_s, name_e = starts[0::4] + 1, nl[0::4]
    seq_s, seq_e = starts[1::4], nl[1::4]
    qual_s, qual_e = starts[3::4], nl[3::4]
    B = name_s.shape[0]

    # toACGT over all sequence bytes at once, preserving the reference's
    # sequential rand() consumption order (reads in order, bases in order:
    # row-major over the (B, lmax) block, padding masked out)
    slens = (seq_e - seq_s).astype(np.int32)
    lmax = int(slens.max())
    col = np.arange(lmax, dtype=np.int32)[None, :]
    valid = col < slens[:, None]
    idx2d = seq_s.astype(np.int32)[:, None] + col
    codes = BASE_TO_CODE[data[np.minimum(idx2d, data.shape[0] - 1)]]
    codes[~valid] = PAD_CODE
    bad = np.flatnonzero(codes == 255)  # row-major == read order, base order
    if bad.size:
        rng = GlibcRand(0)  # srand(0) per batch, mapping.cpp:73
        codes.reshape(-1)[bad] = rng.random_bases(bad.size)
    dec = codes.copy()
    dec[~valid] = 0
    all_bytes = CODE_TO_BASE[dec].tobytes()

    names = []
    seqs = []
    quals = []
    ns, ne = name_s.tolist(), name_e.tolist()
    sl = slens.tolist()
    qs, qe = qual_s.tolist(), qual_e.tolist()
    for i in range(B):
        raw = buf[ns[i] : ne[i]]
        sp = raw.find(b" ")
        names.append((raw if sp < 0 else raw[:sp]).decode())
        seqs.append(all_bytes[i * lmax : i * lmax + sl[i]])
        quals.append(buf[qs[i] : qe[i]])

    lines.take_buffer(int(nl[-1]) + 1)
    return ReadBatch(
        names=names, seqs=seqs, quals=quals, _codes=codes, _lens=slens,
    )


def _load_batch_slow(lines: FgetsLines, n_reads: int, adaptor: bytes = b"") -> ReadBatch:
    """One batch of up to n_reads records (mapping.cpp:65-121)."""
    rng = GlibcRand(0)  # srand(0) per batch, mapping.cpp:73
    names, seqs, quals = [], [], []
    line_code = 0
    line_count = 0
    lim = n_reads * 4
    name = seq = None
    while line_count < lim:
        raw = lines.next_line()
        if raw is None:
            break
        line = raw[:-1]  # cline[strlen-1] = 0: strip exactly one byte
        if len(line) == 0:
            continue
        if line_code == 0:
            sp = line.find(b" ")
            name = line[1:] if sp < 0 else line[1:sp]
        elif line_code == 1:
            s = bytearray(line)
            if adaptor:
                clip_adaptor(s, adaptor)
            # toACGT per byte, in order (consumes rand() for each non-ACGT)
            codes = BASE_TO_CODE[np.frombuffer(bytes(s), dtype=np.uint8)]
            bad = np.flatnonzero(codes == 255)
            if bad.size:
                codes = codes.copy()
                codes[bad] = rng.random_bases(bad.size)
            seq = CODE_TO_BASE[codes].tobytes()
        elif line_code == 3:
            names.append(name.decode())
            seqs.append(seq)
            quals.append(bytes(line))
        line_count += 1
        line_code = (line_code + 1) & 3
    return ReadBatch(names=names, seqs=seqs, quals=quals)
