"""walt_tpu_torch's paired-end path against walt_tpu and the exact host path.

Exact equality throughout:

- ``map_strand_core(emit_wl=True)`` == walt_tpu's (the Pallas verify kernel
  in interpret mode, ``WALTX_PALLAS=1``) on the CT and GA tables;
- ``flat_from_wl`` and ``map_mate_device`` == ``walt_tpu.ops.pe_map`` on
  chunks that do not spill; on a spilling chunk the port zeroes the spilled
  reads' counts and flags them, where walt_tpu's decoder would read past
  the flat stream (fault F1 of the reference);
- ``TorchBackend.map_mate_slabs`` == ``JaxBackend.map_mate_slabs`` and, on
  every read the device resolved, == ``NumpyBackend.map_strand``;
- PE runs stay byte-identical to the exact host path when the flat stream
  spills, after an SE run on the same backend (fault F2: the PE tables
  take the wide key-word rung), after a device out-of-memory error, and
  without the native library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walt_tpu_torch import perf
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.host.fastq import FgetsLines, load_batch
from walt_tpu_torch.index import io_walt
from walt_tpu.ops import device_index as jdi
from walt_tpu.ops import pe_map as jpe
from walt_tpu.ops import pipeline as jpipe
from walt_tpu_torch.core.torch_backend import TABLE_NAMES, TorchBackend
from walt_tpu_torch.ops import device_index as tdi
from walt_tpu_torch.ops import packing
from walt_tpu_torch.ops import pe_map as tpe
from walt_tpu_torch.ops import pipeline as tpipe

PATTERN = get_pattern("3")
C = jpipe.CAND_SLAB
_ORDER = ("pseq", "counter", "index", "key_words", "start_index",
          "bucket_flagged")
_UNIQ = ("uniq_words", "uniq_off", "uniq_counter")


@pytest.fixture(scope="module")
def pe_tables(my_index):
    """[[CT00, CT01], [GA10, GA11]] as (genome, table) pairs."""
    gm, _ = io_walt.read_head(my_index)
    return [[io_walt.read_table_cached(my_index + s, gm) for s in pair]
            for pair in (("_CT00", "_CT01"), ("_GA10", "_GA11"))]


@pytest.fixture(scope="module")
def mates(pe_fastq):
    """(codes, lens) of mate 1 and mate 2."""
    out = []
    for fq in pe_fastq:
        lines = FgetsLines(fq)
        out.append(load_batch(lines, 10**6).packed())
        lines.close()
    return out


@pytest.fixture(scope="module")
def both_strand_reads(work):
    """Seeded bisulfite reads from both genome strands, 30-100 bp, as
    {ag_wildcard: (codes, lens)}: C->T reads for the CT tables and their
    reverse complements (G->A reads) for the GA tables."""
    from walt_tpu_torch.genome import load_genome
    from walt_tpu_torch.synth import sample_reads

    g = load_genome([str(work / "genome.fa")])
    codes, _, _ = sample_reads(g, 96, 100, seed=29)
    rng = np.random.default_rng(31)
    lens = rng.choice([100, 100, 90, 80, 45, 30], 96).astype(np.int32)
    out = {}
    for ag, c in ((False, codes), (True, (3 - codes)[:, ::-1])):
        c = np.ascontiguousarray(c)
        c[np.arange(100)[None, :] >= lens[:, None]] = 0
        out[ag] = (c, lens)
    return out


def _packed(codes):
    L = -(-codes.shape[1] // 16) * 16
    return packing.pack_codes_np(
        np.pad(codes, ((0, 0), (0, L - codes.shape[1]))))


def _table_pair(g, ht, rung):
    """(jax tables, torch tables, search_bits, uniq_bits) on one rung."""
    dt = tdi.build_device_table(g, ht, PATTERN)
    tt = tdi.place_table(dt, "cpu")
    jt = {k: jnp.asarray(np.asarray(getattr(dt, k))) for k in _ORDER[:3]
          + _ORDER[4:]}
    ubits = 0
    if rung == "uniq":
        uw, uo, uc, ubits = tdi.build_uniq_device(
            tt["pseq"], tt["index"], tt["counter"], PATTERN)
        tt.update(zip(_UNIQ, (uw, uo, uc)))
        tt["key_words"] = torch.zeros((1, 1), dtype=torch.int32)
        ju = jdi.build_uniq_device(jt["pseq"], jt["index"], jt["counter"],
                                   PATTERN)
        jt.update(zip(_UNIQ, ju[:3]))
        assert ju[3] == ubits
        jt["key_words"] = jnp.zeros((1, 1), jnp.uint32)
    else:
        tt["key_words"] = tdi.build_key_words_device(
            tt["pseq"], tt["index"], PATTERN, n_key_words=1)
        jt["key_words"] = jdi.build_key_words_device(
            jt["pseq"], ht.index, PATTERN, n_key_words=1)
    return jt, tt, dt.max_bucket_bits, ubits


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("rung", ["uniq", "word0"])
@pytest.mark.parametrize("table", list(TABLE_NAMES.values()))
def test_emit_wl_matches_jax(pe_tables, both_strand_reads, monkeypatch, table,
                             rung):
    monkeypatch.setenv("WALTX_PALLAS", "1")  # JAX side runs the K1 kernel
    ag = table.startswith("GA")
    g, ht = pe_tables[ag][table.endswith("1")]
    codes, lens = both_strand_reads[ag]
    preads = _packed(codes)
    jt, tt, bits, ubits = _table_pair(g, ht, rung)
    kw = dict(pattern_name="3", ag_wildcard=ag, search_bits=bits,
              verify_slab=tpe.VERIFY_SLAB, wl_factor=tpe.WL_FACTOR,
              uniq_bits=ubits, emit_wl=True,
              full_mask=TorchBackend._full_mask(lens, PATTERN))
    jwl, jcnt, jfb = jpipe.map_strand_core(
        jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000), jnp.int32(6),
        *(jt[k] for k in _ORDER), **{k: jt.get(k) for k in _UNIQ}, **kw)
    twl, tcnt, tfb = tpipe.map_strand_core(
        packing.from_np(preads), torch.from_numpy(lens), 5000, 6,
        *(tt[k] for k in _ORDER), **{k: tt.get(k) for k in _UNIQ}, **kw)
    np.testing.assert_array_equal(_as_np(tcnt), _as_np(jcnt))
    np.testing.assert_array_equal(_as_np(tfb), _as_np(jfb))
    keep = _as_np(jwl[5])
    np.testing.assert_array_equal(_as_np(twl[5]), keep)
    assert keep.sum() > 0
    for name, j, t in zip(("wl_read", "col", "pos", "mm", "shift"), jwl, twl):
        np.testing.assert_array_equal(
            _as_np(t)[keep].astype(np.int64),
            _as_np(j)[keep].astype(np.int64), err_msg=name)


def _random_wls(rng, B):
    """Two consistent strand worklists: per read and strand up to 40 kept
    rows (ranks past the slab included) and dropped rows, shuffled."""
    wls, cnts = [], []
    for _ in range(2):
        k = rng.integers(0, 41, B) * (rng.random(B) < 0.6)
        rows = [(r, j, True) for r in range(B) for j in range(k[r])]
        rows += [(int(r), C, False) for r in rng.integers(0, B, 3 * B)]
        rows = [rows[i] for i in rng.permutation(len(rows))]
        wlr, col, keep = (np.asarray(v) for v in zip(*rows))
        n = len(rows)
        pos = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        mm = rng.integers(0, 7, n).astype(np.int32)
        shift = rng.integers(0, 3, n).astype(np.int32)
        wls.append((wlr.astype(np.int32), col.astype(np.int32), pos, mm,
                    shift, keep.astype(bool)))
        cnts.append(np.minimum(k, C).astype(np.int32))
    fb = rng.random(B) < 0.1
    return wls, cnts, fb


def _flat_both(wls, cnts, fb, flat_factor):
    want = jpe.flat_from_wl(
        [tuple(jnp.asarray(a) for a in wl) for wl in wls],
        [jnp.asarray(c) for c in cnts], jnp.asarray(fb), flat_factor, C)
    got = tpe.flat_from_wl(
        [tuple(torch.from_numpy(a.astype(np.int64)) if a.dtype != bool
               else torch.from_numpy(a) for a in wl) for wl in wls],
        [torch.from_numpy(c) for c in cnts], torch.from_numpy(fb),
        flat_factor, C)
    return ([np.asarray(w).view(np.uint32) for w in want],
            [g.numpy().view(np.uint32) for g in got])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_from_wl_matches_jax(seed):
    rng = np.random.default_rng(seed)
    wls, cnts, fb = _random_wls(rng, 50)
    (jmeta, jflat), (tmeta, tflat) = _flat_both(wls, cnts, fb, 2 * C)
    np.testing.assert_array_equal(tmeta, jmeta)
    np.testing.assert_array_equal(tflat, jflat)
    assert (tmeta & 0xFFFF).sum() > 0


def test_flat_from_wl_spill_flags_and_zeroes():
    """F1: on a spilling chunk the spilled reads (a suffix) carry the
    fallback bit and no count, so the decoded stream stays inside M; the
    flat rows and every other read's meta equal walt_tpu's."""
    rng = np.random.default_rng(5)
    B, M = 50, 4 * 50
    wls, cnts, fb = _random_wls(rng, B)
    (jmeta, jflat), (tmeta, tflat) = _flat_both(wls, cnts, fb, 4)
    total = cnts[0].astype(np.int64) + cnts[1]
    spill = np.cumsum(total) > M
    assert spill.any() and spill[np.argmax(spill):].all()  # a suffix
    np.testing.assert_array_equal(((tmeta >> 16) & 1).astype(bool),
                                  fb | spill)
    np.testing.assert_array_equal(tflat, jflat)
    np.testing.assert_array_equal(tmeta[~spill], jmeta[~spill])
    assert not (tmeta[spill] & 0xFFFF).any()
    landed = (tmeta & 0xFF).astype(np.int64) + ((tmeta >> 8) & 0xFF)
    assert landed.sum() <= M
    # walt_tpu's counts reach past the flat stream
    assert ((jmeta & 0xFF).astype(np.int64) + ((jmeta >> 8) & 0xFF)).sum() > M


@pytest.mark.parametrize("mate", [1, 2])
def test_map_mate_device_matches_jax(pe_tables, both_strand_reads,
                                    monkeypatch, mate):
    monkeypatch.setenv("WALTX_PALLAS", "1")
    ag = mate == 2
    codes, lens = both_strand_reads[ag]
    preads = _packed(codes)
    pairs = [_table_pair(g, ht, "uniq") for g, ht in pe_tables[ag]]
    kw = dict(pattern_name="3", ag_wildcard=ag,
              search_bits=tuple(p[2] for p in pairs),
              uniq_bits=tuple(p[3] for p in pairs),
              verify_slab=tpe.VERIFY_SLAB, wl_factor=tpe.WL_FACTOR,
              flat_factor=tpe.FLAT_FACTOR, cand_slab=C,
              full_mask=TorchBackend._full_mask(lens, PATTERN))
    jmeta, jflat = jpe.map_mate_device(
        jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000),
        jnp.int32(6), tuple(p[0] for p in pairs), **kw)
    tmeta, tflat = tpe.map_mate_device(
        packing.from_np(preads), torch.from_numpy(lens), 5000, 6,
        tuple(p[1] for p in pairs), **kw)
    jmeta = np.asarray(jmeta)
    assert (jmeta & 0xFFFF).sum() > 0 and not ((jmeta >> 16) & 1).all()
    np.testing.assert_array_equal(tmeta.numpy().view(np.uint32), jmeta)
    np.testing.assert_array_equal(tflat.numpy().view(np.uint32),
                                  np.asarray(jflat))


def _mate_slabs(backend, pe_tables, mates, mate):
    codes, lens = mates[mate - 1]
    return backend.map_mate_slabs(codes, lens, pe_tables[mate - 1],
                                  mate == 2, 5000, 6, PATTERN)


def _assert_streams_equal(a, b, rows=slice(None)):
    for sa, sb in zip(a, b):
        for k in ("seed", "pos", "mm", "cnt"):
            np.testing.assert_array_equal(sa[k][rows], sb[k][rows], err_msg=k)


@pytest.mark.parametrize("mate", [1, 2])
def test_map_mate_slabs_matches_jax_and_numpy(pe_tables, mates, mate):
    from walt_tpu.core.backends import NumpyBackend
    from walt_tpu.core.jax_backend import JaxBackend

    # chunk ladder 32/64: several chunks, so the decode offsets are used
    tb = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    reads0 = perf.counters().get("backend.reads", 0)
    streams, fb = _mate_slabs(tb, pe_tables, mates, mate)
    reads = perf.counters().get("backend.reads", 0) - reads0
    jstreams, jfb = _mate_slabs(JaxBackend(chunk=64, small_chunk=32),
                                pe_tables, mates, mate)
    np.testing.assert_array_equal(fb, jfb)
    _assert_streams_equal(streams, jstreams)
    for st in streams:
        assert all(st[k].flags.c_contiguous for k in st)
        assert (st["seed"].dtype, st["pos"].dtype, st["mm"].dtype,
                st["cnt"].dtype) == (np.int8, np.uint32, np.int32, np.int32)
    assert set(tb.rungs) == {("GA1" if mate == 2 else "CT0") + s
                             for s in "01"}
    assert reads == mates[0][0].shape[0]
    codes, lens = mates[mate - 1]
    for st, (g, ht) in zip(streams, pe_tables[mate - 1]):
        ref = NumpyBackend().map_strand(codes, lens, g, ht, mate == 2, 5000,
                                        6, PATTERN)
        for i in np.flatnonzero(~fb):
            c = int(st["cnt"][i])
            got = list(zip(st["seed"][i, :c].tolist(),
                           st["pos"][i, :c].tolist(),
                           st["mm"][i, :c].tolist()))
            assert got == [tuple(map(int, x)) for x in ref[i]], i
    assert (~fb).mean() > 0.9


def _read_all(out):
    """The MR output and its .mapstats, as bytes."""
    out_bytes = []
    for f in (out, out + ".mapstats"):
        with open(f, "rb") as fh:
            out_bytes.append(fh.read())
    return out_bytes


def _numpy_pe(tmp_path, my_index, pe_fastq):
    from walt_tpu.cli import main_map

    ref = str(tmp_path / "numpy.mr")
    main_map(["-i", my_index, "-1", pe_fastq[0], "-2", pe_fastq[1], "-o",
              ref, "--backend", "numpy"])
    return _read_all(ref)


def _torch_pe_cli(tmp_path, my_index, pe_fastq, name="torch.mr"):
    from walt_tpu_torch import cli as tcli

    out = str(tmp_path / name)
    assert tcli.main(["-i", my_index, "-1", pe_fastq[0], "-2", pe_fastq[1],
                      "-o", out, "--device", "cpu"]) == 0
    return _read_all(out)


def _small_chunk_backends(monkeypatch):
    """Make the CLI's torch backend use 32/64-read chunks; returns the list
    the backends it builds are appended to."""
    from walt_tpu_torch.core import backends

    made = []

    def get_backend(name, **kw):
        b = TorchBackend(chunk=64, small_chunk=32, **kw)
        made.append(b)
        return b

    monkeypatch.setattr(backends, "get_backend", get_backend)
    return made


def test_flat_spill_falls_back(tmp_path, monkeypatch, my_index, pe_fastq,
                               pe_tables, mates):
    """F1: with one flat slot per read the chunks spill; map_mate_slabs
    flags the spilled reads instead of failing, resolved reads keep their
    streams, and the CLI output stays byte-identical to the exact path."""
    clean = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    fb0 = perf.counters().get("backend.fallback_reads", 0)
    want = [_mate_slabs(clean, pe_tables, mates, m) for m in (1, 2)]
    clean_fb = perf.counters().get("backend.fallback_reads", 0) - fb0
    monkeypatch.setattr(tpe, "FLAT_FACTOR", 1)
    spill = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    for m, (ws, wfb) in zip((1, 2), want):
        streams, fb = _mate_slabs(spill, pe_tables, mates, m)
        assert (fb & ~wfb).sum() > 10  # spilled reads were flagged
        assert not (~fb & wfb).any()
        _assert_streams_equal(streams, ws, ~fb)
    _small_chunk_backends(monkeypatch)
    fb0 = perf.counters().get("backend.fallback_reads", 0)
    got = _torch_pe_cli(tmp_path, my_index, pe_fastq)
    assert perf.counters().get("backend.fallback_reads", 0) - fb0 > clean_fb
    assert got == _numpy_pe(tmp_path, my_index, pe_fastq)


def _disable_uniq(monkeypatch):
    real = tdi.build_uniq_device
    monkeypatch.setattr(tdi, "build_uniq_device",
                        lambda *a, **kw: real(*a, **dict(kw, max_bytes=8)))


def test_pe_after_se_takes_wide_rung(tmp_path, monkeypatch, my_index,
                                     se_fastq, pe_fastq):
    """F2: an SE run builds the CT tables on key16 (no uniq index, native
    library present); the PE run on the same backend rebuilds them on the
    wide u32 word-0 rung, holds one copy of each of the four tables, and
    both outputs stay byte-identical to the exact path."""
    from walt_tpu_torch import native
    from walt_tpu.cli import main_map
    from walt_tpu_torch.cli import main as tmain

    if native.get_lib() is None:
        pytest.skip("native library unavailable (key16 is not chosen first)")
    se_ref = str(tmp_path / "se_numpy.mr")
    main_map(["-i", my_index, "-r", se_fastq, "-o", se_ref, "--backend",
              "numpy"])
    pe_want = _numpy_pe(tmp_path, my_index, pe_fastq)
    _disable_uniq(monkeypatch)
    made = _small_chunk_backends(monkeypatch)
    se_out, pe_out = str(tmp_path / "se.mr"), str(tmp_path / "pe.mr")
    assert tmain(["-i", my_index, "-r", se_fastq, "-1", pe_fastq[0], "-2",
                  pe_fastq[1], "-o", f"{se_out},{pe_out}",
                  "--device", "cpu"]) == 0
    backend = made[0]
    assert backend.rungs == {t: "u32 word0" for t in TABLE_NAMES.values()}
    assert len(backend._tables) == 4
    assert _read_all(pe_out) == pe_want
    assert _read_all(se_out) == _read_all(se_ref)


@pytest.mark.parametrize("where", ["begin", "finish"])
def test_mate_step_oom_stays_identical(tmp_path, monkeypatch, my_index,
                                       pe_fastq, where):
    """A CUDA out-of-memory error in the mate step (launch or wait) sends
    the batch to the exact host path: output byte-identical to a clean
    run."""
    want = _torch_pe_cli(tmp_path, my_index, pe_fastq, "clean.mr")
    bombs = [1]

    def once(real):
        def f(*a, **kw):
            if bombs[0]:
                bombs[0] -= 1
                raise torch.cuda.OutOfMemoryError("CUDA out of memory "
                                                  "(injected)")
            return real(*a, **kw)
        return f

    if where == "begin":
        monkeypatch.setattr(tpe, "map_mate_device", once(tpe.map_mate_device))
    else:
        monkeypatch.setattr(TorchBackend, "_wait", once(TorchBackend._wait))
    got = _torch_pe_cli(tmp_path, my_index, pe_fastq, "oom.mr")
    assert bombs == [0]
    assert got == want


def test_pe_without_native_library(tmp_path, monkeypatch, my_index,
                                   pe_fastq):
    """Without the native library process_paired_end takes map_strand (slab
    tiers + host enumeration): byte-identical all the same."""
    from walt_tpu_torch import native

    want = _numpy_pe(tmp_path, my_index, pe_fastq)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert _torch_pe_cli(tmp_path, my_index, pe_fastq) == want
