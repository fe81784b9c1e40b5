"""walt_tpu_torch's stage recorder (``ops/stages``) against walt_tpu's stage
profiler, on the CPU at a toy size.

- Outputs with a recording ``stages`` are bit-identical to ``stages=None``:
  the SE step on the uniq, key16, u32 word-0 and ``exact_b`` rungs, the PE
  mate step (``emit_wl``) on the uniq, key16 and u32 word-0 rungs, and a
  routed tp=2 shard on the uniq and key16 accels, as slabs and as the
  ``emit_wl`` stream.
- With ``stages=None`` no CUDA event, profiler range or host sync is made.
- The stage names and their order per mode.
- At the ``keys``, ``search`` and ``membership`` marks, walt_tpu's
  ``stage_out`` checksums (``walt_tpu/ops/pipeline.py:299-302``,
  ``:459-460``, ``:501-502``) computed from the live tensors equal what
  walt_tpu returns for ``stage_out`` on the same seeded inputs, exactly, on
  the uniq, entry (u32 word 0) and key16 paths and on both shards of a
  routed tp=2 split.  ``worklist`` and ``verify`` are not compared: the
  fused verify stage moved their boundary (walt_tpu's worklist stage ends
  after the index gather, the chromosome search and
  ``ok_head``/``ok_tail``, which the port's fused verify kernel does), so
  no port mark sees walt_tpu's worklist checksum.
- ``chip_smoke.device_profile`` (phase 3) on made-up traces: it counts
  only device events launched in its window (not a warm-up call's record
  or the profiler's step range) and profiles a window that lost a launch's
  device record again, at most ``PROFILE_ATTEMPTS`` times.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from walt_tpu.ops import device_index as jdi
from walt_tpu.ops import pipeline as jpipe
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.ops import device_index as tdi
from walt_tpu_torch.ops import packing, pe_map, se_fold
from walt_tpu_torch.ops import pipeline as tpipe
from walt_tpu_torch.ops import stages as st
from walt_tpu_torch.parallel import sharded as tsh

PATTERN = get_pattern("3")
ORDER = ("pseq", "counter", "index", "key_words", "start_index",
         "bucket_flagged")
SE_NAMES = ([(t, s) for t in (0, 1) for s in st.STRAND_STAGES]
            + [(None, "fold")])
PE_NAMES = SE_NAMES[:-1] + [(None, "flat")]


@pytest.fixture(scope="module")
def host_tables():
    """The C->T tables of a 200 kbp genome with repeat families: its word-0
    runs hold several entries, so a run index differs from the entry index
    it points at (a uniform toy genome's runs are nearly all single
    entries, and a search mark that passed run indices would go unseen)."""
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.synth import make_genome_repetitive

    genome = make_genome_repetitive(200_000, n_chroms=2, seed=5)
    return [build_table(genome, c, PATTERN, verbose=False)
            for c in ("CT00", "CT01")]


def _reads(genome, lengths, seed):
    """Packed bisulfite reads of 100 bp cut to ``lengths``."""
    from walt_tpu_torch.synth import sample_reads

    codes, _, _ = sample_reads(genome, len(lengths), 100, seed=seed)
    lens = np.asarray(lengths, dtype=np.int32)
    codes[np.arange(100)[None, :] >= lens[:, None]] = 0
    return packing.pack_codes_np(np.pad(codes, ((0, 0), (0, 12)))), lens


def _mixed_lengths(n, seed):
    return list(np.random.default_rng(seed).choice([100, 90, 80, 45, 30], n))


def _torch_table(g, ht, rung):
    """(tensors, search bits, uniq bits) of one table on a rung."""
    dt = tdi.build_device_table(g, ht, PATTERN)
    t = tdi.place_table(dt, "cpu")
    t["key_words"] = torch.zeros((1, 1), dtype=torch.int32)
    ubits = 0
    if rung == "uniq":
        t["uniq_words"], t["uniq_off"], t["uniq_counter"], ubits = \
            tdi.build_uniq_device(t["pseq"], t["index"], t["counter"],
                                  PATTERN)
    elif rung == "key16":
        t["key_words"] = tdi.build_key16_device(t["pseq"], t["index"],
                                                PATTERN)
    else:
        t["key_words"] = tdi.build_key_words_device(
            t["pseq"], t["index"], PATTERN,
            n_key_words=3 if rung == "exact_b" else 1)
    return t, dt.max_bucket_bits, ubits


def _se_step(tabs, preads, lens, exact_b, stages):
    tables, bits, ubits = zip(*tabs)
    return se_fold.map_single_end_device(
        packing.from_np(preads), torch.from_numpy(lens), 3 if exact_b
        else 5000, 6, tables, pattern_name="3", ag_wildcard=False,
        search_bits=bits, uniq_bits=ubits, verify_slab=8, wl_factor=1.5,
        exact_b=exact_b, stages=stages)


def _pe_step(tabs, preads, lens, stages):
    tables, bits, ubits = zip(*tabs)
    return pe_map.map_mate_device(
        packing.from_np(preads), torch.from_numpy(lens), 5000, 6, tables,
        pattern_name="3", ag_wildcard=False, search_bits=bits,
        verify_slab=pe_map.VERIFY_SLAB, cand_slab=tpipe.CAND_SLAB,
        wl_factor=pe_map.WL_FACTOR, flat_factor=pe_map.FLAT_FACTOR,
        uniq_bits=ubits, stages=stages)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _equal(x, y)
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("rung", ["uniq", "key16", "word0", "exact_b"])
def test_se_step_with_stages_is_bit_identical(host_tables, rung):
    tabs = [_torch_table(g, ht, rung) for g, ht in host_tables]
    preads, lens = _reads(host_tables[0][0], _mixed_lengths(96, 3), seed=9)
    exact_b = rung == "exact_b"
    want = _se_step(tabs, preads, lens, exact_b, None)
    log = st.StageLog()
    _equal((_se_step(tabs, preads, lens, exact_b, log),), (want,))
    assert log.names() == SE_NAMES
    assert torch.equal(log.marks[-1].live["packed"], want)
    assert int((want[:, 1] > 0).sum()) > 0  # reads mapped


@pytest.mark.parametrize("rung", ["uniq", "key16", "word0"])
def test_pe_step_with_stages_is_bit_identical(host_tables, rung):
    tabs = [_torch_table(g, ht, rung) for g, ht in host_tables]
    preads, lens = _reads(host_tables[0][0], [100] * 64, seed=21)
    want = _pe_step(tabs, preads, lens, None)
    log = st.StageLog()
    _equal(_pe_step(tabs, preads, lens, log), want)
    assert log.names() == PE_NAMES
    # under emit_wl the compact mark carries the worklist stream the step
    # packs into the flat rows
    assert set(log.marks[5].live) == {"wl", "cand_cnt", "fallback"}
    assert int((want[0] & 0xFFFF).sum()) > 0  # candidates were found


@pytest.fixture(scope="module")
def split(host_tables):
    """tp=2 host shards of CT00 (the layout test_torch_sharded uses), by
    accel: "uniq" (word-0 runs) and "key16" (16-bit prefix keys)."""
    g, ht = host_tables[0]
    dt = tdi.build_device_table(g, ht, PATTERN, with_key_words=True)
    return {accel: tsh.shard_device_table(dt, 2, accel=accel)
            for accel in ("uniq", "key16")}


@pytest.fixture(scope="module")
def shards(split):
    return split["uniq"]


def _shard_inputs(stt, s):
    """One shard's table and uniq arguments; a key16 shard passes its
    prefix keys and no uniq runs."""
    key16 = stt.key_words.dtype == np.uint16
    table = [stt.pseq, stt.counter[s], stt.index[s],
             stt.key_words[s] if key16 else np.zeros((1, 1), np.uint32),
             stt.start_index, stt.bucket_flagged[s]]
    uniq = ([None] * 3 if key16 else
            [stt.uniq_words[s], stt.uniq_off[s], stt.uniq_counter[s]])
    return table, uniq


def _t(a):
    if a is None:
        return None
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16))
    return torch.from_numpy(a) if a.dtype == np.uint8 else \
        packing.from_np(np.ascontiguousarray(a))


def _routed(stt, s, preads, lens, stages, emit_wl=False):
    table, uniq = _shard_inputs(stt, s)
    with st.strand_pass(stages, 0):
        return tpipe.map_strand_core(
            packing.from_np(preads), torch.from_numpy(lens), 5000, 6,
            *(_t(a) for a in table), pattern_name="3", ag_wildcard=False,
            search_bits=stt.max_bucket_bits, verify_slab=8, wl_factor=1.5,
            uniq_words=_t(uniq[0]), uniq_off=_t(uniq[1]),
            uniq_counter=_t(uniq[2]), uniq_bits=stt.uniq_bits,
            key_base=int(stt.key_base[s]), tp_route=2, emit_wl=emit_wl,
            stages=stages)


@pytest.mark.parametrize("accel", ["uniq", "key16"])
@pytest.mark.parametrize("emit_wl", [False, True])
def test_routed_shard_with_stages_is_bit_identical(host_tables, split,
                                                   emit_wl, accel):
    preads, lens = _reads(host_tables[0][0], [100] * 96, seed=4)
    for s in range(2):
        want = _routed(split[accel], s, preads, lens, None, emit_wl)
        log = st.StageLog()
        _equal(_routed(split[accel], s, preads, lens, log, emit_wl), want)
        assert log.names() == [(0, n) for n in st.STRAND_STAGES]


def test_no_recording_without_stages(host_tables, shards):
    """stages=None makes no CUDA event, no profiler range and no host
    sync on any path: each would raise here."""
    tabs = [_torch_table(g, ht, "uniq") for g, ht in host_tables]
    preads, lens = _reads(host_tables[0][0], _mixed_lengths(64, 5), seed=2)

    def boom(*a, **k):
        raise AssertionError("recorded or synchronized with stages=None")

    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.cuda, "Event", boom)
        m.setattr(torch.cuda, "synchronize", boom)
        m.setattr(torch.profiler, "record_function", boom)
        m.setattr(torch.autograd.profiler, "record_function", boom)
        for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                     "__int__", "__float__"):
            m.setattr(torch.Tensor, name, boom)
        se = _se_step(tabs, preads, lens, False, None)
        pe = _pe_step(tabs, preads, lens, None)
        routed = [_routed(shards, s, preads, lens, None, w)
                  for s in range(2) for w in (False, True)]
    assert se.shape == (64, 3) and pe[1].shape[1] == 2 and len(routed) == 4


def _checksum(stage, live, routed):
    """walt_tpu's stage_out checksum (walt_tpu/ops/pipeline.py:299-302,
    :459-460, :501-502) of the live tensors at the port's mark, wrapped to
    int32 as JAX sums without x64."""
    def total(t):
        return int(t.to(torch.int64).sum())

    if stage == "keys":
        v = (total(live["in_range"]) + total(live["flagged"]) if routed
             else total(live["lo"]) + total(live["hi"])
             + total(live["flagged"]))
    elif stage == "search":
        v = total(live["lower"]) + (0 if live["run_len"] is None
                                    else total(live["run_len"]))
    else:
        v = total(live["refined_cnt"]) + total(live["overflow"])
    return int(np.int64(v).astype(np.int32))


CHECKED = ("keys", "search", "membership")


@pytest.mark.parametrize("rung,full_mask", [
    ("uniq", True), ("uniq", False), ("word0", False), ("key16", False),
])
def test_boundaries_give_walt_tpu_stage_checksums(host_tables, rung,
                                                  full_mask):
    g, ht = host_tables[0]
    lengths = [100] * 64 if full_mask else _mixed_lengths(64, 17)
    preads, lens = _reads(g, lengths, seed=13)
    tab, bits, ubits = _torch_table(g, ht, rung)
    kw = dict(pattern_name="3", ag_wildcard=False, search_bits=bits,
              verify_slab=8, wl_factor=1.5, full_mask=full_mask)
    log = st.StageLog()
    with st.strand_pass(log, 0):
        tpipe.map_strand_core(
            packing.from_np(preads), torch.from_numpy(lens), 5000, 6,
            *(tab[k] for k in ORDER), uniq_words=tab.get("uniq_words"),
            uniq_off=tab.get("uniq_off"),
            uniq_counter=tab.get("uniq_counter"), uniq_bits=ubits,
            stages=log, **kw)
    live = {m.name: m.live for m in log.marks}

    dt = tdi.build_device_table(g, ht, PATTERN)
    pseq = jnp.asarray(dt.pseq)
    jt = dict(pseq=pseq, counter=jnp.asarray(dt.counter),
              index=jnp.asarray(dt.index),
              start_index=jnp.asarray(dt.start_index),
              bucket_flagged=jnp.asarray(dt.bucket_flagged),
              key_words=jnp.zeros((1, 1), jnp.uint32))
    jx = {}
    if rung == "uniq":
        uw, uo, uc, jbits = jdi.build_uniq_device(
            pseq, jt["index"], jt["counter"], PATTERN)
        assert jbits == ubits
        jx = dict(uniq_words=uw, uniq_off=uo, uniq_counter=uc,
                  uniq_bits=jbits)
    elif rung == "key16":
        jt["key_words"] = jdi.build_key16_device(pseq, ht.index, PATTERN)
    else:
        jt["key_words"] = jdi.build_key_words_device(pseq, ht.index, PATTERN,
                                                     n_key_words=1)
    for stage in CHECKED:
        want = jpipe.map_strand_stage(
            jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000),
            jnp.int32(6), *(jt[k] for k in ORDER), stage_out=stage, **kw,
            **jx)
        assert _checksum(stage, live[stage], False) == int(want), stage


def test_routed_boundaries_give_walt_tpu_stage_checksums(host_tables,
                                                         shards):
    """Both shards of a routed tp=2 split: the port's keys mark sits after
    the route compaction (walt_tpu's hook sits before it), and its routed
    checksum reads only in_range and the unrouted flags, which the
    compaction leaves as they were."""
    preads, lens = _reads(host_tables[0][0], _mixed_lengths(96, 8), seed=6)
    for s in range(2):
        log = st.StageLog()
        _routed(shards, s, preads, lens, log)
        live = {m.name: m.live for m in log.marks}
        table, uniq = _shard_inputs(shards, s)
        for stage in CHECKED:
            want = jpipe.map_strand_core(
                jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000),
                jnp.int32(6), *(jnp.asarray(a) for a in table),
                pattern_name="3", ag_wildcard=False,
                search_bits=shards.max_bucket_bits, verify_slab=8,
                wl_factor=1.5, uniq_words=jnp.asarray(uniq[0]),
                uniq_off=jnp.asarray(uniq[1]),
                uniq_counter=jnp.asarray(uniq[2]),
                uniq_bits=shards.uniq_bits, key_base=int(shards.key_base[s]),
                tp_route=2, stage_out=stage)
            assert _checksum(stage, live[stage], True) == int(want), \
                (s, stage)


def _window(reps, lose=()):
    """A made-up chrome trace of ``reps`` one-kernel calls (10 us each,
    correlations 1..reps), less the device records of ``lose``, with a
    kernel of the warm-up call (correlation 0, launched before the window),
    the profiler's step range and a synchronize (no device record)."""
    evs = [dict(cat="kernel", name="verify_kernel", ts=0.0, dur=99.0,
                args=dict(correlation=0)),
           dict(cat="gpu_user_annotation", name="ProfilerStep#1", ts=0.0,
                dur=500.0),
           dict(cat="cuda_runtime", name="cudaDeviceSynchronize", ts=400.0,
                dur=1.0, args=dict(correlation=99))]
    for c in range(1, reps + 1):
        evs.append(dict(cat="cuda_runtime", name="cudaLaunchKernel",
                        ts=10.0 * c, dur=1.0, args=dict(correlation=c)))
        if c not in lose:
            evs.append(dict(cat="kernel", name="verify_kernel",
                            ts=10.0 * c + 5, dur=10.0,
                            args=dict(correlation=c)))
    return evs


@pytest.mark.parametrize("windows,attempts", [
    ([()], 1), ([(2,), (1, 3), ()], 3), ([(1,)] * chip_smoke.PROFILE_ATTEMPTS,
                                         None)],
    ids=["whole", "two-short", "always-short"])
def test_device_profile_counts_the_window_and_retries(monkeypatch, tmp_path,
                                                      windows, attempts):
    made = []

    def fake_profiled(fn, warmup, trace_path):
        open(trace_path, "w").close()
        made.append(trace_path)
        return None, _window(4, windows[len(made) - 1])

    monkeypatch.setattr(st, "profiled", fake_profiled)
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    os.makedirs(tmp_path / "build")
    if attempts is None:
        with pytest.raises(AssertionError, match="no profiling window"):
            chip_smoke.device_profile(lambda: None, reps=4, events=1)
        assert len(made) == chip_smoke.PROFILE_ATTEMPTS
        return
    ms, per_call = chip_smoke.device_profile(lambda: None, reps=4, events=1)
    assert (ms, per_call) == (0.01, 1.0) and len(made) == attempts
    assert not any(os.path.exists(p) for p in made)
    # without a count to hold, the first window is taken as it is
    monkeypatch.setattr(st, "profiled", lambda fn, warmup, trace_path: (
        open(trace_path, "w").close(), _window(4, (2,))))
    assert chip_smoke.device_profile(lambda: None, reps=4) == (0.0075, 0.75)
