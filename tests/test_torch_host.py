"""walt_tpu_torch's host layer (a copy of walt_tpu's) equals walt_tpu's.

On seeded inputs, exact equality throughout:

- ``index.build.build_table`` arrays, for all four conversions;
- ``index.io_walt``: an index written by either package is read by the
  other, and both write the same bytes;
- ``index.convert``: a walt_tpu ``Genome``/``HashTable`` handed over as
  arrays becomes the port's types with the same fields;
- ``host.fastq.load_batch``: codes, lengths, names, sequences, qualities,
  also batch by batch over streams that return short reads, against the
  exact line-by-line loop too; a batch's buffer stays its own after the
  next batch is loaded, and the fill's copy counters stay near one;
- ``host.replay_vec.replay_single_batch`` (the NumPy spec of the device
  fold) on seeded candidate slabs, and the port's device fold against it;
- the emitted MR and SAM lines and ``.mapstats`` of the SE and PE drivers
  on the exact host backend;
- the native library: ``se_exact``, ``pe_exact_ranked`` +
  ``pe_join_ranked`` and ``pe_finalize``;
- the port's native library builds race-free: six processes that build it
  into one fresh directory at the same moment all load it.
"""

import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from walt_tpu import native as jnative
from walt_tpu.constants import get_pattern as jget_pattern
from walt_tpu.host import fastq as jfastq
from walt_tpu.host import replay_vec as jreplay_vec
from walt_tpu.index import build as jbuild
from walt_tpu.index import io_walt as jio
from walt_tpu.synth import make_genome as jmake_genome
from walt_tpu_torch import native as tnative
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.host import fastq as tfastq
from walt_tpu_torch.host import replay_vec
from walt_tpu_torch.index import build as tbuild
from walt_tpu_torch.index import convert
from walt_tpu_torch.index import io_walt as tio
from walt_tpu_torch.synth import make_genome, sample_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATTERN = get_pattern("3")


def _same_genome(a, b):
    assert list(a.names) == list(b.names)
    assert a.strand == b.strand
    for f in ("lengths", "start_index", "seq"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _same_table(a, b):
    for f in ("counter", "index"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed,max_mm,C", [(0, 6, 16), (1, 6, 32), (2, 2, 8),
                                          (3, 0, 16), (4, 6, 1)])
def test_replay_vec_matches_walt_tpu(seed, max_mm, C):
    """Random slabs over a tiny position alphabet (adjacent-duplicate and
    anchor cases) with empty slots (seed -1) and positions past 2^31."""
    import torch

    from walt_tpu_torch.ops import se_fold

    rng = np.random.default_rng(300 + seed)
    B = 80
    slabs = []
    for _ in range(2):
        cs = rng.integers(-1, PATTERN.pattern_len, (B, C)).astype(np.int8)
        cp = rng.integers(0, 5, (B, C)).astype(np.uint32)
        cp[rng.random((B, C)) < 0.05] = 0xFFFFFFF0
        cm = rng.integers(0, 7, (B, C)).astype(np.int32)
        slabs.append((cs, cp, cm))
    got = replay_vec.replay_single_batch(slabs, max_mm, PATTERN)
    want = jreplay_vec.replay_single_batch(slabs, max_mm,
                                           jget_pattern("3"))
    fold = se_fold.se_fold(
        [(torch.from_numpy(a), torch.from_numpy(b.astype(np.int64)),
          torch.from_numpy(c)) for a, b, c in slabs], max_mm, PATTERN)
    for g, w, f in zip(got, want, fold):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(f.numpy().astype(g.dtype), g)


@pytest.fixture(scope="module")
def genomes():
    """The same seeded 60 kbp genome from each package's synth."""
    return jmake_genome(60_000, n_chroms=3, seed=4), \
        make_genome(60_000, n_chroms=3, seed=4)


@pytest.mark.parametrize("conv", ["CT00", "CT01", "GA10", "GA11"])
def test_build_table_matches_walt_tpu(genomes, conv):
    jg, tg = genomes
    _same_genome(jg, tg)
    want = jbuild.build_table(jg, conv, jget_pattern("3"), verbose=False)
    got = tbuild.build_table(tg, conv, PATTERN, verbose=False)
    _same_genome(want[0], got[0])
    _same_table(want[1], got[1])
    assert got[1].index_size > 0


def test_convert_hands_walt_tpu_tables_to_the_port(genomes):
    jg, _ = genomes
    g, ht = jbuild.build_table(jg, "CT01", jget_pattern("3"), verbose=False)
    tg = convert.genome_from_arrays(g.names, g.lengths, g.start_index, g.seq,
                                    g.strand)
    tt = convert.table_from_arrays(ht.counter, ht.index)
    assert type(tg).__module__ == "walt_tpu_torch.genome"
    assert type(tt).__module__ == "walt_tpu_torch.index.build"
    _same_genome(g, tg)
    _same_table(ht, tt)
    assert tg.n_chroms == g.n_chroms and tt.counter_size == ht.counter_size
    with pytest.raises(ValueError):
        convert.genome_from_arrays(g.names, g.lengths, g.start_index,
                                   g.seq[:-1])
    with pytest.raises(ValueError):
        convert.table_from_arrays(ht.counter, ht.index[:-1])


@pytest.mark.parametrize("writer", ["walt_tpu", "port"])
def test_io_walt_round_trip_across_packages(tmp_path, genomes, writer):
    """Both packages write the same index bytes from the same genome, and
    an index written by one package is read back by the other."""
    jg, tg = genomes
    convs = ("CT00", "CT01", "GA10", "GA11")
    jt = {c: jbuild.build_table(jg, c, jget_pattern("3"), verbose=False)
          for c in convs}
    tt = {c: tbuild.build_table(tg, c, PATTERN, verbose=False)
          for c in convs}
    jpath, tpath = (str(tmp_path / f"{k}.dbindex") for k in ("j", "t"))
    jio.write_index(jpath, jg, jt)
    tio.write_index(tpath, tg, tt)
    for suf in ("", "_CT00", "_CT01", "_GA10", "_GA11"):
        with open(jpath + suf, "rb") as a, open(tpath + suf, "rb") as b:
            assert a.read() == b.read(), suf
    src, r_io, tables = ((jpath, tio, jt) if writer == "walt_tpu"
                         else (tpath, jio, tt))
    gm, size = r_io.read_head(src)
    assert list(gm.names) == list(tg.names)
    np.testing.assert_array_equal(gm.start_index, tg.start_index)
    assert size == max(t.index_size for _, t in tables.values())
    for c in convs:
        g, ht = r_io.read_table(src + "_" + c, gm)
        _same_genome(tables[c][0], g)
        _same_table(tables[c][1], ht)


def _batch(mod, path, n, adaptor=b""):
    lines = mod.FgetsLines(path)
    try:
        return mod.load_batch(lines, n, adaptor)
    finally:
        lines.close()


@pytest.mark.parametrize("adaptor", [b"", b"AGATCGGAAGAGC"],
                         ids=["plain", "adaptor"])
def test_load_batch_matches_walt_tpu(se_fastq, adaptor):
    want = _batch(jfastq, se_fastq, 10**6, adaptor)
    got = _batch(tfastq, se_fastq, 10**6, adaptor)
    for a, b in zip(got.packed(), want.packed()):
        np.testing.assert_array_equal(a, b)
    assert got.names == want.names
    assert got.seqs == want.seqs
    assert got.quals == want.quals
    assert len(got) > 100


class _ShortReads:
    """A stream that hands back at most ``size`` bytes per read, as a pipe
    may, so records, lines and the ``\n+\n`` separator straddle chunks."""

    def __init__(self, data: bytes, size: int):
        self._data, self._pos, self._size = data, 0, size

    def read(self, n=-1):
        k = self._size if n is None or n < 0 else min(n, self._size)
        out = self._data[self._pos: self._pos + k]
        self._pos += len(out)
        return out

    def close(self):
        pass


def _fastq_text(n, seed, long_at=None, empty_at=None, trailing=True):
    """``n`` FASTQ records of 20-120 bases (some N and lower-case bases,
    names with a comment): record ``long_at`` holds a 1,200-byte sequence
    and quality line, an empty line follows record ``empty_at``, and the
    text ends without its last newline unless ``trailing``."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        L = 1200 if i == long_at else int(rng.integers(20, 121))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTACGTACGTNa", np.uint8),
                               L))
        qual = bytes(rng.integers(33, 74, L).astype(np.uint8))
        recs.append(b"@r%d x:%d\n%s\n+\n%s\n" % (i, i % 7, seq, qual))
        if i == empty_at:
            recs.append(b"\n")
    text = b"".join(recs)
    return text if trailing else text[:-1]


def _all_batches(load, lines, n):
    out = []
    while True:
        b = load(lines, n)
        if not len(b):
            return out
        out.append(b)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g.packed(), w.packed()):
            np.testing.assert_array_equal(a, b)
        assert g.names == w.names
        assert g.seqs == w.seqs
        assert g.quals == w.quals


# (records, read size (None: as much as asked), batch, text options)
_STREAMS = {
    "short_reads": (300, 7, 64, {}),
    "eof_newline": (101, 13, 40, {}),
    "eof_no_newline": (101, 13, 40, dict(trailing=False)),
    "long_line": (90, 11, 40, dict(long_at=45)),
    "empty_line": (90, 5, 40, dict(empty_at=50)),
    "leftover_3_batches": (120, None, 40, {}),
}


@pytest.mark.parametrize("case", list(_STREAMS))
def test_load_batch_over_a_stream_matches_walt_tpu(monkeypatch, case):
    """Every batch of a stream read in small chunks equals walt_tpu's
    ``load_batch`` on the whole text and the port's exact line-by-line
    loop over the same chunks; where the native parse refuses a buffer,
    the NumPy path is handed that very buffer.  (``long_line`` ends
    mid-record: the split lines leave two lines past the last record.)"""
    n_recs, size, n, opts = _STREAMS[case]
    text = _fastq_text(n_recs, seed=len(case), **opts)

    def stream():
        return io.BytesIO(text) if size is None else _ShortReads(text, size)

    # walt_tpu's NumPy and exact paths: its native scan drops the records
    # of a batch that ends mid-record at EOF (F10)
    monkeypatch.setattr(jfastq, "_load_batch_native", lambda lines, n: None)
    want = _all_batches(jfastq.load_batch, jfastq.FgetsLines(io.BytesIO(text)),
                        n)
    refused, handed = [], []
    real_parse, real_fast = tnative.fastq_parse, tfastq._load_batch_fast

    def parse(buf, max_reads):
        got = real_parse(buf, max_reads)
        if got is None:
            refused.append(buf)
        return got

    def fast(lines, n_reads):
        handed.append(lines._buf)
        return real_fast(lines, n_reads)

    monkeypatch.setattr(tnative, "fastq_parse", parse)
    monkeypatch.setattr(tfastq, "_load_batch_fast", fast)
    got = _all_batches(tfastq.load_batch, tfastq.FgetsLines(stream()), n)
    monkeypatch.undo()
    slow = _all_batches(tfastq._load_batch_slow,
                        tfastq.FgetsLines(stream()), n)
    _same_batches(got, want)
    _same_batches(slow, want)
    assert sum(len(b) for b in want) == n_recs
    if tnative.get_lib() is not None:
        assert len(handed) == len(refused)
        assert all(h is r for h, r in zip(handed, refused))
        if "long_at" in opts or "empty_at" in opts:
            assert refused


def test_a_batch_keeps_its_buffer_after_the_next_is_loaded():
    """Batch i's ``native`` buffer is immutable and unchanged after batch
    i+1 is parsed, and its lazy names and qualities, first built then,
    equal walt_tpu's."""
    if tnative.get_lib() is None:
        pytest.skip("g++ unavailable")
    text = _fastq_text(150, seed=3)
    want = _all_batches(jfastq.load_batch, jfastq.FgetsLines(io.BytesIO(text)),
                        50)
    lines = tfastq.FgetsLines(_ShortReads(text, 1000))
    first = tfastq.load_batch(lines, 50)
    buf = first.native[0]
    kept = bytes(bytearray(buf))
    second = tfastq.load_batch(lines, 50)
    third = tfastq.load_batch(lines, 50)
    assert isinstance(buf, bytes)
    assert first.native[0] is buf and buf == kept
    assert second.native[0] is not buf and third.native[0] is not buf
    assert first.names == want[0].names
    assert first.quals == want[0].quals
    assert first.seqs == want[0].seqs


@pytest.mark.parametrize("size", [None, 4096, 7], ids=["whole", "4k", "7"])
def test_fill_copies_each_stream_byte_at_most_twice(size):
    """Over a multi-batch stream the parse buffers take at most twice the
    bytes read from the stream (``parse.buffer_bytes`` against
    ``parse.stream_bytes``); a buffer grown by appends took about 26."""
    from walt_tpu_torch import perf

    text = _fastq_text(600, seed=9)
    perf.reset()
    lines = tfastq.FgetsLines(io.BytesIO(text) if size is None
                              else _ShortReads(text, size))
    got = _all_batches(tfastq.load_batch, lines, 100)
    c = perf.counters()
    perf.reset()
    assert sum(len(b) for b in got) == 600
    assert c["parse.stream_bytes"] == len(text)
    assert len(text) <= c["parse.buffer_bytes"] <= 2 * len(text)


@pytest.mark.parametrize("path", [False, True], ids=["stream", "file"])
def test_fill_asks_for_bounded_pieces(tmp_path, monkeypatch, path):
    """A batch of more reads than the input holds (1 << 40: to the end)
    reads it to its end in pieces of at most ``_MAX_READ`` bytes: a file's
    read(n) allocates n bytes first, and the whole batch's estimate would
    not fit in memory."""
    text = _fastq_text(300, seed=5)
    # an in-memory stream's read(n) returns what it holds
    want = tfastq.load_batch(tfastq.FgetsLines(io.BytesIO(text)), 1 << 40)
    asked = []

    class Asked(io.BytesIO):
        def read(self, n=-1):
            asked.append(n)
            return super().read(n)

    monkeypatch.setattr(tfastq, "_MAX_READ", 1 << 13)
    if path:
        (tmp_path / "r.fq").write_bytes(text)
        lines = tfastq.FgetsLines(str(tmp_path / "r.fq"))
    else:
        lines = tfastq.FgetsLines(Asked(text))
    got = tfastq.load_batch(lines, 1 << 40)
    lines.close()
    assert len(got) == 300
    assert got.seqs == want.seqs and got.names == want.names
    if not path:
        assert max(asked) <= 1 << 13 and len(asked) > len(text) >> 13


def _read_all(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
@pytest.mark.parametrize("sam", [False, True], ids=["mr", "sam"])
def test_emitted_lines_match_walt_tpu(tmp_path, my_index, se_fastq,
                                      pe_fastq, pe, sam):
    """Each package's driver on its own exact host backend, with -a -u:
    the same MR or SAM lines and .mapstats."""
    from walt_tpu.core import backends as jbackends
    from walt_tpu.core.paired_end import process_paired_end as jpe
    from walt_tpu.core.single_end import process_single_end as jse
    from walt_tpu_torch.core import backends as tbackends
    from walt_tpu_torch.core.paired_end import process_paired_end as tpe
    from walt_tpu_torch.core.single_end import process_single_end as tse

    outs = {}
    for name, se_fn, pe_fn, be in (("j", jse, jpe, jbackends),
                                   ("t", tse, tpe, tbackends)):
        out = str(tmp_path / f"{name}.mr")
        for p in (out, out + ".mapstats"):
            open(p, "w").close()
        kw = dict(ambiguous=True, unmapped=True, sam=sam,
                  backend=be.get_backend("numpy"))
        if pe:
            pe_fn(my_index, pe_fastq[0], pe_fastq[1], out, **kw)
        else:
            se_fn(my_index, se_fastq, out, **kw)
        extra = [] if sam else (
            [f"{out}_{m}_{k}" for m in ("1", "2")
             for k in ("ambiguous", "unmapped")] if pe
            else [f"{out}_ambiguous", f"{out}_unmapped"])
        outs[name] = _read_all([out, out + ".mapstats", *extra])
    assert outs["t"] == outs["j"]
    assert len(outs["t"][0]) > 1000


def _walt_native():
    """walt_tpu's native library.  Its build races when processes start at
    once (fault F5): a process that lost the race caches None, so ask once
    more before skipping."""
    if jnative.get_lib() is None:
        time.sleep(1.0)
        jnative._tried = False
        if jnative.get_lib() is None:
            pytest.skip("walt_tpu's native library is unavailable")
    if tnative.get_lib() is None:
        pytest.skip("g++ unavailable")


@pytest.fixture(scope="module")
def index_tables(my_index):
    """{name: (genome, table)} read by each package from one index."""
    out = {}
    for key, io in (("j", jio), ("t", tio)):
        gm, _ = io.read_head(my_index)
        out[key] = {s: io.read_table_cached(my_index + "_" + s, gm)
                    for s in ("CT00", "CT01", "GA10", "GA11")}
    return out


@pytest.mark.parametrize("ag", [False, True], ids=["ct", "ga"])
def test_native_se_exact_matches_walt_tpu(index_tables, ag):
    _walt_native()
    names = ("GA10", "GA11") if ag else ("CT00", "CT01")
    g = index_tables["t"][names[0]][0]
    codes, lens, _ = sample_reads(g, 400, 90, seed=71)
    if ag:  # G->A reads: reverse complements of C->T ones
        codes = np.ascontiguousarray((3 - codes)[:, ::-1])
    lens = lens.copy()
    lens[::7] = 30  # reads shorter than the 38 bp minimum too
    # past its length a read holds base code 0, as in a batch the port's
    # exact paths map (a hash key that reaches past the read reads 0)
    codes[np.arange(codes.shape[1])[None, :] >= lens[:, None]] = 0
    want = jnative.se_exact(codes, lens,
                            [index_tables["j"][n] for n in names], ag, 5000,
                            6, jget_pattern("3"))
    got = tnative.se_exact(codes, lens,
                           [index_tables["t"][n] for n in names], ag, 5000,
                           6, PATTERN)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[1] > 0).sum() > 100  # reads were mapped


def test_native_pe_paths_match_walt_tpu(index_tables, pe_fastq):
    """pe_exact_ranked + pe_join_ranked on all pairs, and pe_finalize on the
    port's device streams (CPU), from both packages' libraries."""
    from walt_tpu_torch.core.torch_backend import TorchBackend

    _walt_native()
    mates = [_batch(tfastq, f, 10**6).packed() for f in pe_fastq]
    (c1, l1), (c2, l2) = mates
    l1, l2 = l1.astype(np.int32), l2.astype(np.int32)
    chrom_start = index_tables["t"]["CT00"][0].start_index.astype(np.uint32)
    pairs = (("CT00", "CT01"), ("GA10", "GA11"))
    results = {}
    for key, lib, pat in (("j", jnative, jget_pattern("3")),
                          ("t", tnative, PATTERN)):
        tabs = [[index_tables[key][n] for n in p] for p in pairs]
        ranked = [lib.pe_exact_ranked(c, n, t, ag, 5000, 6, 50, pat)
                  for c, n, t, ag in ((c1, l1, tabs[0], False),
                                      (c2, l2, tabs[1], True))]
        results[key] = [lib.pe_join_ranked(ranked[0], ranked[1], l1, l2,
                                           chrom_start, 1000, 6, 50)]
    backend = TorchBackend(device="cpu")
    s1, fb1 = backend.map_mate_slabs(c1, l1, [index_tables["t"][n]
                                              for n in pairs[0]],
                                     False, 5000, 6, PATTERN)
    s2, fb2 = backend.map_mate_slabs(c2, l2, [index_tables["t"][n]
                                              for n in pairs[1]],
                                     True, 5000, 6, PATTERN)
    skip = (fb1 | fb2).astype(np.uint8)
    for key, lib in (("j", jnative), ("t", tnative)):
        results[key].append(lib.pe_finalize(
            s1 + s2, skip, l1, l2, chrom_start, 50, 1000, 6,
            PATTERN.exit1_seed))
    for got, want in zip(results["t"], results["j"]):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (results["t"][0]["code"] == 0).sum() > 50  # unique pairs


_BUILD = r"""
import sys, time
from walt_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
start = float(sys.argv[2])
while time.time() < start:
    time.sleep(0.001)
lib = native.get_lib()
assert lib is not None, "the native library did not load"
parsed = native.fastq_parse(b"@r1\nACGTN\n+\nIIIII\n", 4)
assert parsed is not None and parsed[3].tolist() == [5], parsed
print("LOADED", native.lib_path())
"""


def test_native_build_is_race_free(tmp_path):
    """Six processes build the port's native library into one fresh
    directory at the same moment; every one of them loads it, and no
    temporary file is left behind."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    build = tmp_path / "native"
    env = dict(os.environ, PYTHONPATH=ROOT)
    start = time.time() + 4.0  # every interpreter is up by then
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build),
                               repr(start)], env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == f"LOADED {build / tnative.LIB_NAME}"
    assert sorted(os.listdir(build)) == [tnative.LIB_NAME]
