"""walt_tpu_torch's strand pipeline and backend against walt_tpu.

- ``map_strand_core`` == walt_tpu's ``map_strand_core`` (the Pallas verify
  kernel in interpret mode, ``WALTX_PALLAS=1``) on every output, for the
  uniq, u32 word-0 and key16 rungs with ``full_mask`` on and off, and the
  3-word ``exact_b`` path;
- ``TorchBackend(device="cpu").map_strand`` == the exact ``NumpyBackend``
  (the differential of tests/test_device_pipeline.py);
- ``map_single_end`` on each pinned rung == the native exact replay on every
  read the device resolved.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walt_tpu_torch import perf
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.index import io_walt
from walt_tpu.ops import device_index as jdi
from walt_tpu.ops import pipeline as jpipe
from walt_tpu_torch.core.torch_backend import TorchBackend
from walt_tpu_torch.ops import device_index as tdi
from walt_tpu_torch.ops import packing
from walt_tpu_torch.ops import pipeline as tpipe


@pytest.fixture(scope="module")
def table(my_index):
    gm, _ = io_walt.read_head(my_index)
    return io_walt.read_table_cached(my_index + "_CT00", gm)


@pytest.fixture(scope="module")
def se_tables(my_index):
    gm, _ = io_walt.read_head(my_index)
    return [io_walt.read_table_cached(my_index + s, gm)
            for s in ("_CT00", "_CT01")]


def _reads(genome, lengths, seed):
    """Bisulfite reads of 100 bp cut to ``lengths`` (zero codes past len)."""
    from walt_tpu_torch.synth import sample_reads

    codes, _, _ = sample_reads(genome, len(lengths), 100, seed=seed)
    lens = np.asarray(lengths, dtype=np.int32)
    codes[np.arange(100)[None, :] >= lens[:, None]] = 0
    return codes, lens


def _jax_tables(dt, ht, pattern, rung):
    pseq = jnp.asarray(dt.pseq)
    tabs = dict(pseq=pseq, counter=jnp.asarray(dt.counter),
                index=jnp.asarray(dt.index),
                start_index=jnp.asarray(dt.start_index),
                bucket_flagged=jnp.asarray(dt.bucket_flagged),
                key_words=jnp.zeros((1, 1), jnp.uint32))
    extra = {}
    if rung == "uniq":
        uw, uo, uc, bits = jdi.build_uniq_device(
            pseq, tabs["index"], tabs["counter"], get_pattern("3"))
        extra = dict(uniq_words=uw, uniq_off=uo, uniq_counter=uc,
                     uniq_bits=bits)
    elif rung == "key16":
        tabs["key_words"] = jdi.build_key16_device(pseq, ht.index, pattern)
    else:
        tabs["key_words"] = jdi.build_key_words_device(
            pseq, ht.index, pattern, n_key_words=3 if rung == "3-word" else 1)
    return tabs, extra


def _torch_tables(dt, pattern, rung):
    tabs = tdi.place_table(dt, "cpu")
    tabs["key_words"] = torch.zeros((1, 1), dtype=torch.int32)
    extra = {}
    if rung == "uniq":
        uw, uo, uc, bits = tdi.build_uniq_device(
            tabs["pseq"], tabs["index"], tabs["counter"], pattern)
        extra = dict(uniq_words=uw, uniq_off=uo, uniq_counter=uc,
                     uniq_bits=bits)
    elif rung == "key16":
        tabs["key_words"] = tdi.build_key16_device(
            tabs["pseq"], tabs["index"], pattern)
    else:
        tabs["key_words"] = tdi.build_key_words_device(
            tabs["pseq"], tabs["index"], pattern,
            n_key_words=3 if rung == "3-word" else 1)
    return tabs, extra


_ORDER = ("pseq", "counter", "index", "key_words", "start_index",
          "bucket_flagged")


@pytest.mark.parametrize("rung,full_mask", [
    ("uniq", True), ("uniq", False), ("word0", True), ("word0", False),
    ("key16", True), ("key16", False), ("3-word", False),
])
def test_map_strand_core_matches_jax(table, monkeypatch, rung, full_mask):
    monkeypatch.setenv("WALTX_PALLAS", "1")  # JAX side runs the K1 kernel
    g, ht = table
    pattern = get_pattern("3")
    dt = tdi.build_device_table(g, ht, pattern)
    rng = np.random.default_rng(17)
    lengths = ([100] * 64 if full_mask
               else list(rng.choice([100, 90, 80, 45, 30], 64)))
    codes, lens = _reads(g, lengths, seed=5 + len(rung))
    preads = packing.pack_codes_np(np.pad(codes, ((0, 0), (0, 12))))
    b = 3 if rung == "3-word" else 5000
    kw = dict(pattern_name="3", ag_wildcard=False,
              search_bits=dt.max_bucket_bits, exact_b=rung == "3-word",
              full_mask=full_mask)

    jt, jx = _jax_tables(dt, ht, pattern, rung)
    want = jpipe.map_strand_core(
        jnp.asarray(preads), jnp.asarray(lens), jnp.int32(b), jnp.int32(6),
        *(jt[k] for k in _ORDER), **kw, **jx)
    tt, tx = _torch_tables(dt, pattern, rung)
    got = tpipe.map_strand_core(
        packing.from_np(preads), torch.from_numpy(lens), b, 6,
        *(tt[k] for k in _ORDER), **kw, **tx)

    names = ("cand_seed", "cand_pos", "cand_mm", "cand_cnt", "fallback")
    for name, w, t in zip(names, want, got):
        w = np.asarray(w)
        np.testing.assert_array_equal(t.numpy().astype(w.dtype), w,
                                      err_msg=name)
    assert int(np.asarray(want[3]).sum()) > 0  # candidates were found


def _as_tuples(s):
    return [(int(x), int(y), int(z)) for x, y, z in s]


def _diff_vs_numpy(table, fastq, backend, ag_wildcard=False, b=5000,
                   max_mm=6):
    from walt_tpu.core.backends import NumpyBackend
    from walt_tpu_torch.host.fastq import FgetsLines, load_batch

    g, ht = table
    pattern = get_pattern("3")
    codes, lens = load_batch(FgetsLines(fastq), 10**6).packed()
    ref = NumpyBackend().map_strand(codes, lens, g, ht, ag_wildcard, b,
                                    max_mm, pattern)
    got = backend.map_strand(codes, lens, g, ht, ag_wildcard, b, max_mm,
                             pattern)
    bad = [i for i in range(len(ref))
           if _as_tuples(ref[i]) != _as_tuples(got[i])]
    assert not bad, f"{len(bad)} reads diverge, first: {bad[:5]}"


@pytest.mark.parametrize("ag_wildcard", [False, True])
@pytest.mark.parametrize("b,max_mm", [(5000, 6), (3, 6), (5000, 0)])
def test_map_strand_vs_numpy(table, se_fastq, ag_wildcard, b, max_mm):
    _diff_vs_numpy(table, se_fastq, TorchBackend(device="cpu"),
                   ag_wildcard, b, max_mm)


def test_backend_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(device="cuda")


def test_small_slabs_force_fallback(table, se_fastq):
    backend = TorchBackend(device="cpu", verify_slab=2, cand_slab=2)
    fb0 = perf.counters().get("backend.fallback_reads", 0)
    _diff_vs_numpy(table, se_fastq, backend)
    # the tiny slabs actually overflowed
    assert perf.counters().get("backend.fallback_reads", 0) > fb0


@pytest.mark.parametrize("rung", ["uniq", "word0", "key16"])
def test_map_single_end_rungs_vs_native(se_tables, monkeypatch, rung):
    from walt_tpu_torch import native
    from walt_tpu_torch.synth import sample_reads

    monkeypatch.setenv("WALTX_KEY_RUNG", rung)
    pattern = get_pattern("3")
    genome = se_tables[0][0]
    codes, lens, _ = sample_reads(genome, 600, 100, seed=41)
    backend = TorchBackend(device="cpu", small_chunk=256)
    pos, times, minus, mm, fb = backend.map_single_end(
        codes, lens, se_tables, 5000, 6, pattern)
    assert backend.rungs == {"CT00": "uniq" if rung == "uniq" else
                             "u32 word0" if rung == "word0" else "key16",
                             "CT01": backend.rungs["CT00"]}
    ref = native.se_exact(codes, lens, se_tables, False, 5000, 6, pattern)
    if ref is None:
        pytest.skip("native library unavailable")
    ok = ~fb
    assert ok.mean() > 0.9
    for got, want in zip((pos, times, minus, mm), ref):
        np.testing.assert_array_equal(got[ok], want[ok])


def _oom(*a, **kw):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")


def _run_se(index, fastq, out, backend):
    from walt_tpu_torch.core.single_end import process_single_end

    open(out, "w").close()
    open(out + ".mapstats", "w").close()
    process_single_end(index, fastq, out, batch_size=64, backend=backend)
    with open(out) as a, open(out + ".mapstats") as b:
        return a.read(), b.read()


@pytest.mark.parametrize("where", ["uniq", "word0", "map", "budget"])
def test_oom_degrades_and_stays_identical(tmp_path, monkeypatch, my_index,
                                          se_fastq, where):
    """A device OOM in the uniq build degrades to a key-word rung, one in
    the u32 word-0 build to key16, one while mapping (or a table over the
    memory budget) sends the batch to the exact host path; the output is
    byte-identical in every case."""
    from walt_tpu.core.backends import NumpyBackend
    from walt_tpu_torch.core.errors import HbmBudgetError

    want = _run_se(my_index, se_fastq, str(tmp_path / "ref.mr"),
                   NumpyBackend())
    backend = TorchBackend(device="cpu", chunk=256, small_chunk=64)
    if where == "uniq":
        monkeypatch.setattr(tdi, "build_uniq_device", _oom)
    elif where == "word0":
        monkeypatch.setenv("WALTX_KEY_RUNG", "word0")
        monkeypatch.setattr(tdi, "build_key_words_device", _oom)
    elif where == "map":
        monkeypatch.setattr(tpipe, "map_strand_core", _oom)
    else:
        monkeypatch.setattr(backend, "_hbm_budget", lambda: 1 << 20)
    got = _run_se(my_index, se_fastq, str(tmp_path / "got.mr"), backend)
    assert got == want
    if where == "uniq":
        assert set(backend.rungs.values()) == {"key16"}
    elif where == "word0":
        assert set(backend.rungs.values()) == {"key16"}
    elif where == "budget":
        gm, _ = io_walt.read_head(my_index)
        g, ht = io_walt.read_table_cached(my_index + "_CT00", gm)
        with pytest.raises(HbmBudgetError):
            backend._device_table(g, ht, get_pattern("3"))
