"""Seed patterns 5 and 7 through the port, against walt_tpu on the CPU.

The golden tests pin pattern 3; patterns 5 and 7 (seedpattern.hpp:29-352,
the reference's ``-D SEEDPATTERN5/7``) run here on a small repetitive
genome whose tables hold buckets of more than 24 entries, so the native
bucket sort takes its packed-column path.  The port's CLI builds the
index (``index --seed-pattern``); both packages read the same files.
Exact equality throughout:

- (a) the tables: every entry inside the genome, each bucket a permutation
  of ``native.csr_build``'s, adjacent entries in the reference
  comparator's order (reference.cpp:258-300); patterns 3 and 5 byte-
  identical to walt_tpu's builder (walt_tpu's sort overruns its three
  packed columns under pattern 7's 68 cared positions: fault F7);
- (b) 23-24 bp pattern-7 reads, whose hash keys reach past the read: the
  port's ``--backend numpy`` equals its torch backend and its exact host
  path (all read base code 0 there; walt_tpu's ``--backend numpy`` raises
  and its device and native paths disagree: fault F9);
- (c)-(e) of walt_tpu's JAX programs: ``tests/test_torch_patterns_backends.py``;
- the index as walt_tpu reads it, handed over by ``index/convert``; the
  device tables and their uniq / key16 / key-word rungs;
- (f) the CLI, SE and PE, with ``-a -u``, ``-sam``, ``-A`` and ``-P``, ==
  ``walt_tpu.cli --backend numpy``.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import AllFallback
from tests.test_torch_cli import _assert_same
from walt_tpu_torch import cli as tcli
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.index import io_walt

GENOME_BP = 150_000
SUFFIXES = ("_CT00", "_CT01", "_GA10", "_GA11")


def _write_reads(g, path, n, seed, lo, hi):
    """n bisulfite reads of ``lo``..``hi`` bp (3' ends trimmed) as FASTQ."""
    from walt_tpu_torch.synth import codes_to_fastq, sample_reads

    codes, _, _ = sample_reads(g, n, hi, seed=seed, err_rate=0.02)
    lens = np.random.default_rng(seed + 1).integers(lo, hi + 1, n)
    codes_to_fastq(codes, lens.astype(np.int32), path)
    return path


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """{pattern: dict(index, genome, reads, short, pairs)} made on first use:
    the port's CLI index of one repetitive genome, SE reads from key_span
    to 150 bp with too-short ones, 23-24 bp reads (pattern 7) and 2x60 bp
    pairs."""
    from walt_tpu_torch.genome import load_genome
    from walt_tpu_torch.synth import (
        codes_to_fastq, make_genome_repetitive, sample_pairs,
        write_genome_fasta,
    )

    d = tmp_path_factory.mktemp("patterns")
    fa = str(d / "genome.fa")
    write_genome_fasta(make_genome_repetitive(GENOME_BP, n_chroms=2, seed=42),
                       fa)
    g = load_genome([fa])
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        p = get_pattern(name)
        index = str(d / f"p{name}.dbindex")
        assert tcli.main(["index", "-c", fa, "-o", index, "--seed-pattern",
                          name]) == 0
        reads = str(d / f"se{name}.fq")
        _write_reads(g, reads, 150, 13, p.key_span, 150)
        with open(reads, "a") as f, open(_write_reads(
                g, str(d / f"tiny{name}.fq"), 20, 15, p.min_read_len - 8,
                p.min_read_len - 1)) as t:
            f.write(t.read())
        c1, l1, c2, l2 = sample_pairs(g, 60, 60, seed=17, frag_lo=100,
                                      frag_hi=300)
        pairs = (str(d / f"pe{name}_1.fq"), str(d / f"pe{name}_2.fq"))
        codes_to_fastq(c1, l1, pairs[0])
        codes_to_fastq(c2, l2, pairs[1])
        cache[name] = dict(index=index, genome=g, fasta=fa, reads=reads,
                           pairs=pairs)
        if name == "7":
            cache[name]["short"] = _write_reads(g, str(d / "short7.fq"), 200,
                                                19, 23, 24)
            c1, l1, c2, l2 = sample_pairs(g, 60, 24, seed=21, frag_lo=60,
                                          frag_hi=200)
            cache[name]["short_pairs"] = (str(d / "pe_short_1.fq"),
                                          str(d / "pe_short_2.fq"))
            codes_to_fastq(c1, l1, cache[name]["short_pairs"][0])
            codes_to_fastq(c2, l2, cache[name]["short_pairs"][1])
        return cache[name]

    return get


def _tables(index):
    gm, _ = io_walt.read_head(index)
    return {s: io_walt.read_table_cached(index + s, gm) for s in SUFFIXES}


def _packed_batch(fq):
    """(codes, lens) of a FASTQ file, base code 0 past each read's end."""
    from walt_tpu_torch.host.fastq import FgetsLines, load_batch

    lines = FgetsLines(fq)
    codes, lens = load_batch(lines, 10**6).packed()
    lines.close()
    codes = codes.copy()
    codes[np.arange(codes.shape[1])[None, :] >= lens[:, None]] = 0
    return codes, lens


# ---- (a) the index: fault F7 -------------------------------------------

def _comparator_values(g, entries, pattern):
    """(n, cared_size - key_weight) comparator values of the reference's
    text comparator (finalize.cpp cmp_text): base + 1 at each cared
    position past the key, 0 past the entry's chromosome end."""
    chrom = np.searchsorted(g.start_index, entries, side="right") - 1
    remain = g.start_index.astype(np.int64)[chrom + 1] - entries
    offs = pattern.cared[pattern.key_weight:].astype(np.int64)
    pos = entries[:, None] + offs[None, :]
    vals = g.seq[np.minimum(pos, len(g.seq) - 1)] + np.uint8(1)
    return np.where(offs[None, :] < remain[:, None], vals, np.uint8(0))


@pytest.mark.parametrize("name", ["5", "7"])
def test_index_tables_in_genome_and_in_comparator_order(datasets, name):
    from walt_tpu_torch import native

    data, pattern = datasets(name), get_pattern(name)
    n_big = 0
    for suffix, (g, ht) in _tables(data["index"]).items():
        assert int(ht.index.max()) < len(g.seq), suffix
        counter = ht.counter.astype(np.int64)
        sizes = np.diff(counter)
        n_big += int((sizes > 24).sum())
        want = native.csr_build(g.seq, g.start_index, pattern.cared,
                                int(pattern.key_weight),
                                int(pattern.min_seed_len), 500_000)
        np.testing.assert_array_equal(want[0], ht.counter)
        bucket = np.repeat(np.arange(len(sizes)), sizes)
        # a permutation of the CSR build's bucket
        np.testing.assert_array_equal(
            np.lexsort((want[1], bucket)).size, ht.index.size)
        np.testing.assert_array_equal(
            want[1][np.lexsort((want[1], bucket))],
            ht.index[np.lexsort((ht.index, bucket))])
        # adjacent entries of a bucket: the later never sorts before
        same = np.flatnonzero(bucket[1:] == bucket[:-1])
        a = _comparator_values(g, ht.index[same].astype(np.int64), pattern)
        b = _comparator_values(g, ht.index[same + 1].astype(np.int64),
                               pattern)
        diff = a != b
        first = np.argmax(diff, axis=1)
        rows = np.flatnonzero(diff.any(1))
        assert (a[rows, first[rows]] < b[rows, first[rows]]).all(), suffix
    assert n_big > 0  # the packed-column path ran


@pytest.mark.parametrize("name", ["3", "5"])
def test_index_bytes_equal_walt_tpu_builder(datasets, tmp_path, name):
    from walt_tpu.constants import get_pattern as jpattern
    from walt_tpu.index.build import build_all_tables
    from walt_tpu.index.io_walt import write_index

    fa = datasets("5")["fasta"]
    ours = str(tmp_path / "port.dbindex")
    assert tcli.main(["index", "-c", fa, "-o", ours, "--seed-pattern",
                      name]) == 0
    theirs = str(tmp_path / "walt_tpu.dbindex")
    genome, tables = build_all_tables([fa], jpattern(name), verbose=False)
    write_index(theirs, genome, tables)
    for s in ("",) + SUFFIXES:
        with open(ours + s, "rb") as x, open(theirs + s, "rb") as y:
            assert x.read() == y.read(), s


def test_sort_refuses_past_capacity():
    from walt_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    seq = np.zeros(1000, np.uint8)
    cared = np.arange(100, dtype=np.uint32)
    counter = np.array([0, 3], np.uint32)
    index = np.array([5, 1, 3], np.uint32)
    with pytest.raises(ValueError, match="capacity"):
        native.sort_buckets(seq, np.array([0, 1000], np.uint32), counter,
                            index, cared, 12, 12 + 81)
    assert native.sort_buckets(seq, np.array([0, 1000], np.uint32), counter,
                               index, cared, 12, 12 + 80)
    np.testing.assert_array_equal(index, [5, 1, 3])  # full ties stay put


# ---- (b) 23-24 bp pattern-7 reads: fault F9 ------------------------------

@pytest.mark.parametrize("flags", [["-a", "-u"], ["-A"], ["pe"]],
                         ids=lambda f: " ".join(f))
def test_short_reads_numpy_equals_torch_and_exact(datasets, tmp_path, flags):
    from walt_tpu_torch.core.single_end import process_single_end

    data = datasets("7")
    pe = flags == ["pe"]
    flags = [] if pe else flags
    reads = (["-1", data["short_pairs"][0], "-2", data["short_pairs"][1]]
             if pe else ["-r", data["short"]])
    common = ["-i", data["index"], *reads, "--seed-pattern", "7", *flags]
    ref, out = str(tmp_path / "numpy.mr"), str(tmp_path / "torch.mr")
    assert tcli.main([*common, "-o", ref, "--backend", "numpy"]) == 0
    assert tcli.main([*common, "-o", out, "--device", "cpu"]) == 0
    _assert_same(ref, out, flags, pe)
    with open(out, "rb") as f:
        assert f.read().count(b"\n") > 50  # the reads map
    if not pe:
        exact = str(tmp_path / "exact.mr")
        open(exact, "w").close()
        process_single_end(data["index"], data["short"], exact,
                           backend=AllFallback(), pattern_name="7",
                           ag_wildcard="-A" in flags, ambiguous="-a" in flags,
                           unmapped="-u" in flags)
        _assert_same(exact, out, flags)


# ---- the device tables and their rungs --------------------------------

@pytest.mark.parametrize("name", ["5", "7"])
def test_device_tables_match_walt_tpu(datasets, name):
    import jax.numpy as jnp

    from walt_tpu.index import io_walt as jio
    from walt_tpu.ops import device_index as jdi
    from walt_tpu_torch.core.refmap import padded_seq
    from walt_tpu_torch.index.convert import (
        genome_from_arrays, table_from_arrays,
    )
    from walt_tpu_torch.ops import device_index as tdi

    pattern = get_pattern(name)
    index = datasets(name)["index"]
    g, ht = _tables(index)["_GA11"]
    # walt_tpu's reader, handed over by index/convert: the same state
    jm, _ = jio.read_head(index)
    jg, jht = jio.read_table(index + "_GA11", jm)
    cg = genome_from_arrays(jg.names, jg.lengths, jg.start_index, jg.seq,
                            jg.strand)
    ct = table_from_arrays(jht.counter, jht.index)
    assert (cg.names, cg.strand) == (g.names, g.strand)
    for a, b in ((cg.seq, g.seq), (cg.start_index, g.start_index),
                 (ct.counter, ht.counter), (ct.index, ht.index)):
        np.testing.assert_array_equal(a, b)
    dt = tdi.build_device_table(g, ht, pattern, with_key_words=True)
    want = jdi.build_device_table(g, ht, pattern, with_key_words=True)
    for f in ("pseq", "counter", "index", "start_index", "bucket_flagged",
              "key_words"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(want, f),
                                      err_msg=f)
    assert dt.max_bucket_bits == want.max_bucket_bits
    dev = tdi.place_table(dt, "cpu")
    for n_key_words in (1, 3):
        got = tdi.build_key_words_device(dev["pseq"], dev["index"], pattern,
                                          chunk=1 << 12,
                                          n_key_words=n_key_words)
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32),
            np.asarray(jdi.build_key_words_device(
                jnp.asarray(dt.pseq), ht.index, pattern,
                n_key_words=n_key_words)))
    got16 = tdi.build_key16_device(dev["pseq"], dev["index"], pattern)
    np.testing.assert_array_equal(
        got16.numpy().view(np.uint16),
        np.asarray(jdi.build_key16_device(jnp.asarray(dt.pseq), ht.index,
                                          pattern)))
    w0 = tdi.pack_key_words(padded_seq(g, pattern), ht.index, pattern)[:, 0]
    h_uw, h_uo, h_uc, h_bits = tdi.build_uniq_host(w0, ht.counter)
    uw, uo, uc, bits = tdi.build_uniq_device(dev["pseq"], dev["index"],
                                             dev["counter"], pattern)
    assert bits == h_bits
    for a, b in ((uw, h_uw), (uo, h_uo), (uc, h_uc)):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), b)


# ---- (f) the CLI --------------------------------------------------------

CLI_CASES = [("se", ["-a", "-u"]), ("se", ["-sam"]), ("se", ["-A"]),
             ("pe", []), ("pe", ["-sam"]), ("pe", ["-a", "-u"]),
             ("pe", ["-P"])]


@pytest.mark.parametrize("mode,flags", CLI_CASES,
                         ids=[f"{m} {' '.join(f)}".strip()
                              for m, f in CLI_CASES])
@pytest.mark.parametrize("name", ["5", "7"])
def test_cli_matches_walt_tpu_numpy(datasets, tmp_path, name, mode, flags):
    from walt_tpu.cli import main_map

    data = datasets(name)
    reads = (["-r", data["reads"]] if mode == "se"
             else ["-1", data["pairs"][0], "-2", data["pairs"][1]])
    common = ["-i", data["index"], *reads, "--seed-pattern", name, *flags]
    ref, out = str(tmp_path / "numpy.mr"), str(tmp_path / "torch.mr")
    main_map([*common, "-o", ref, "--backend", "numpy"])
    assert tcli.main([*common, "-o", out, "--device", "cpu"]) == 0
    _assert_same(ref, out, flags, pe=mode == "pe")
