"""Genome positions past 2^31 through the port's device path, on the CPU.

The port carries u32 positions in int32 tensors, where a position >= 2^31
is negative.  These tests place a small repeat-structured genome (200 kbp,
two chromosomes) behind a filler chromosome of F bases, so its first
chromosome straddles 2^31: the *shifted* table is the small one with F
added to every ``index`` entry, ``counter`` unchanged (the filler is never
indexed), its packed words at word offset F/16 of a zero ``pseq`` (numpy's
zero pages: ~540 MB of address space, resident only where written or
copied), and ``start_index`` with the filler in front.  Then:

- ``map_strand_core`` on the shifted tables equals walt_tpu's on the same
  inputs, and the port's on the unshifted tables with every candidate moved
  by F, on each key rung;
- ``se_fold`` of the shifted slabs equals walt_tpu's fold of them, and the
  unshifted fold moved by F;
- the backend's SE result pack, the PE flat stream's decode and the
  tp-sharded steps (uniq and key16 shards on a CPU mesh) give the unshifted
  results moved by F, with positions on both sides of 2^31.

Memory: the only resident copy of the shifted words is walt_tpu's (its
comparisons run last), and freed heap goes back to the system after every
build and test, so a process running this module peaks at ~1.4 GiB.
"""

import ctypes
import ctypes.util
import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walt_tpu.ops import device_index as jdi
from walt_tpu.ops import pipeline as jpipe
from walt_tpu.ops import se_fold as jfold
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.core.torch_backend import TorchBackend
from walt_tpu_torch.ops import device_index as tdi
from walt_tpu_torch.ops import packing, pipeline, se_fold
from walt_tpu_torch.parallel import sharded

#: filler bases in front of the small genome: a multiple of 16, so the
#: small genome's packed words keep their bits; its first chromosome
#: (~100 kbp) then spans 2^31
F = (1 << 31) - 50_000
RUNGS = ("uniq", "word0", "key16", "3-word")
_ORDER = ("pseq", "counter", "index", "key_words", "start_index",
          "bucket_flagged")
_LIBC = ctypes.CDLL(ctypes.util.find_library("c"))


def _release():
    """Hand freed heap pages back to the system.  The table builder's
    4^12-bucket temporaries (~0.45 GB) and the strand steps' leave the
    process's heap fragmented, and its resident size would otherwise hold
    them after they are freed."""
    gc.collect()
    if hasattr(_LIBC, "malloc_trim"):  # glibc
        _LIBC.malloc_trim(0)


@pytest.fixture(autouse=True)
def _released():
    yield
    _release()


def shifted(dt: tdi.DeviceTable) -> tdi.DeviceTable:
    """``dt`` behind the filler chromosome."""
    pseq = np.zeros(F // 16 + dt.pseq.shape[0], np.uint32)
    pseq[F // 16:] = dt.pseq
    return dataclasses.replace(
        dt, pseq=pseq, index=dt.index + np.uint32(F),
        start_index=np.concatenate([[0], dt.start_index.astype(np.int64)
                                    + F]).astype(np.uint32))


@pytest.fixture(scope="module")
def small():
    """(genome, {conv: (converted genome, table, dt, shifted dt)}, SE reads,
    pairs)."""
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.synth import (
        make_genome_repetitive, sample_pairs, sample_reads,
    )

    pattern = get_pattern("3")
    genome = make_genome_repetitive(200_000, n_chroms=2, seed=23)
    assert F + int(genome.lengths[0]) > 1 << 31  # the first one straddles
    tables = {}
    for conv in ("CT00", "CT01"):
        # one sorting thread: the builder's per-thread histograms would
        # otherwise take most of this process's memory
        g, ht = build_table(genome, conv, pattern, verbose=False,
                            sort_threads=1)
        _release()
        dt = tdi.build_device_table(g, ht, pattern)
        _release()
        tables[conv] = (g, ht, dt, shifted(dt))
        _release()
    codes, lens, _ = sample_reads(genome, 600, 100, seed=31)
    _release()
    pairs = sample_pairs(genome, 300, 100, seed=37)
    _release()
    return genome, tables, (codes, lens), pairs


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


def _jax_tables(dt, pseq, pattern, rung, runs=None, keys_from=None):
    """walt_tpu's tables of ``dt`` (``pseq``: its packed words as a JAX
    array).  Its key words (key16, 3-word) come from ``keys_from``, the
    unshifted table: keys hold bases, not positions, so they are the
    shifted table's, and its builders then never copy the ~540 MB of
    shifted words.  The uniq rung searches ``runs``, the port's run arrays
    of the same table (key words and entry offsets, no positions; equal to
    walt_tpu's by :func:`test_uniq_runs_do_not_move`)."""
    src = dt if keys_from is None else keys_from
    tabs = dict(pseq=pseq, counter=jnp.asarray(dt.counter),
                index=jnp.asarray(dt.index),
                start_index=jnp.asarray(dt.start_index),
                bucket_flagged=jnp.asarray(dt.bucket_flagged),
                key_words=jnp.zeros((1, 1), jnp.uint32))
    extra = {}
    if rung == "uniq":
        extra = {k: jnp.asarray(runs[k].numpy().view(np.uint32))
                 for k in ("uniq_words", "uniq_off", "uniq_counter")}
        extra["uniq_bits"] = runs["uniq_bits"]
    elif rung == "key16":
        tabs["key_words"] = jdi.build_key16_device(
            jnp.asarray(src.pseq), src.index, pattern)
    else:
        tabs["key_words"] = jdi.build_key_words_device(
            jnp.asarray(src.pseq), src.index, pattern,
            n_key_words=3 if rung == "3-word" else 1)
    return tabs, extra


def _strand_kw(dt, rung):
    return dict(pattern_name="3", ag_wildcard=False,
                search_bits=dt.max_bucket_bits, exact_b=rung == "3-word",
                full_mask=True)


def _map_strand(dt, pattern, rung, preads, lens, tables=None):
    tt, tx = tables or _torch_tables(dt, pattern, rung)
    return pipeline.map_strand_core(
        packing.from_np(preads), torch.from_numpy(lens),
        3 if rung == "3-word" else 5000, 6, *(tt[k] for k in _ORDER),
        **_strand_kw(dt, rung), **tx)


def _packed(codes):
    return packing.pack_codes_np(np.pad(codes, ((0, 0), (0, 12))))


def _assert_moved(got, want, what):
    """Candidate slabs ``got`` == ``want`` with every candidate moved by F."""
    cs, cp, cm, cnt, fb = (t.numpy() for t in got)
    ws, wp, wm, wcnt, wfb = (t.numpy() for t in want)
    for name, a, b in (("seed", cs, ws), ("mm", cm, wm), ("cnt", cnt, wcnt),
                       ("fallback", fb, wfb)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    valid = ws >= 0
    np.testing.assert_array_equal(cp[valid], wp[valid] + F,
                                  err_msg=f"{what} pos")
    assert valid.any() and (cp[valid] >= 1 << 31).any() \
        and (cp[valid] < 1 << 31).any()


@pytest.mark.parametrize("conv", ["CT00", "CT01"])
@pytest.mark.parametrize("rung", RUNGS)
def test_map_strand_core_moves_by_F(small, conv, rung):
    """The port on the shifted tables == the port on the unshifted ones,
    every candidate moved by F."""
    genome, tables, (codes, lens), _ = small
    _, _, dt, sdt = tables[conv]
    pattern = get_pattern("3")
    preads = _packed(codes)
    _assert_moved(_map_strand(sdt, pattern, rung, preads, lens),
                  _map_strand(dt, pattern, rung, preads, lens),
                  f"{conv} {rung}")


def test_se_fold_shifted(small):
    """se_fold of the shifted slabs == walt_tpu's fold of the same slabs ==
    the unshifted fold moved by F."""
    genome, tables, (codes, lens), _ = small
    pattern = get_pattern("3")
    preads = _packed(codes)
    slabs, flat = [], []
    for dts in ((tables["CT00"][3], tables["CT01"][3]),
                (tables["CT00"][2], tables["CT01"][2])):
        s = [_map_strand(dt, pattern, "uniq", preads, lens)[:3] for dt in dts]
        slabs.append(s)
        flat.append(se_fold.se_fold(s, 6, pattern))
    (pos, times, minus, mm), (upos, utimes, uminus, umm) = (
        [t.numpy() for t in f] for f in flat)
    for a, b in ((times, utimes), (minus, uminus), (mm, umm)):
        np.testing.assert_array_equal(a, b)
    hit = times > 0
    np.testing.assert_array_equal(pos[hit], upos[hit] + F)
    assert (pos[hit] >= 1 << 31).any() and (pos[hit] < 1 << 31).any()
    want = jfold.se_fold(
        [(jnp.asarray(cs.numpy()), jnp.asarray(cp.numpy().astype(np.uint32)),
          jnp.asarray(cm.numpy())) for cs, cp, cm in slabs[0]], 6, pattern)
    for g, w in zip(flat[0], want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def _cache(backend, tables, pattern, shift: bool, accel=None):
    """Put each table into ``backend``'s table cache as the backend's uniq
    rung (or, on a mesh, ``shard_and_place`` with ``accel``) builds it, from
    the shifted or unshifted host prep; keys are the (genome, table)
    objects the mapping calls pass."""
    for conv in ("CT00", "CT01"):
        g, ht, dt, sdt = tables[conv]
        d = dataclasses.replace(sdt if shift else dt)
        if backend.mesh is not None:
            grid, d.uniq_bits = sharded.shard_and_place(
                d, backend.mesh, pattern, accel=accel)
            entry = (d, grid)
        else:
            dev, extra = _torch_tables(d, pattern, "uniq")
            d.uniq_bits = extra.pop("uniq_bits")
            dev.update(extra)
            entry = (d, dev)
        backend._tables[id(g), id(ht), pattern.name] = entry + (g, ht, True)
    return [tables[c][:2] for c in ("CT00", "CT01")]


def _se_pair(small, **backend_kw):
    genome, tables, (codes, lens), _ = small
    pattern = get_pattern("3")
    accel = backend_kw.pop("accel", None)
    out = []
    for shift in (True, False):
        b = TorchBackend(**backend_kw, tp_accel=accel or "uniq")
        tabs = _cache(b, tables, pattern, shift, accel)
        out.append(b.map_single_end(codes, lens, tabs, 5000, 6, pattern))
    return out


def _assert_se_moved(got, want):
    pos, times, minus, mm, fb = got
    for a, b in zip((times, minus, mm, fb), want[1:]):
        np.testing.assert_array_equal(a, b)
    hit = (times > 0) & ~fb
    assert pos.dtype == np.uint32
    np.testing.assert_array_equal(pos[hit], want[0][hit] + np.uint32(F))
    assert (pos[hit] >= 1 << 31).any() and (pos[hit] < 1 << 31).any()


def test_backend_se_moves_by_F(small):
    """TorchBackend.map_single_end (phase A/B, the fold, the (B, 3) result
    pack and its unpack) on the shifted tables: the unshifted results moved
    by F."""
    _assert_se_moved(*_se_pair(small, device="cpu"))


@pytest.mark.parametrize("accel", ["uniq", "key16"])
def test_mesh_se_moves_by_F(small, accel):
    """The tp=2 sharded SE step on a CPU mesh, uniq and key16 shards (the
    2.24 Gbp plan's layout and the rung its budget falls to)."""
    mesh = sharded.make_mesh(["cpu"] * 2, tp=2)
    _assert_se_moved(*_se_pair(small, mesh=mesh, accel=accel))


@pytest.mark.parametrize("tp", [1, 2])
def test_pe_mate_stream_moves_by_F(small, tp):
    """TorchBackend.map_mate_slabs: the flat stream carries positions past
    2^31 as int32 bits and the host decode reads them back as u32, on one
    device and from tp=2 shards."""
    genome, tables, _, (c1, l1, c2, l2) = small
    pattern = get_pattern("3")
    out = []
    for shift in (True, False):
        mesh = sharded.make_mesh(["cpu"] * 2, tp=2) if tp == 2 else None
        b = TorchBackend(device="cpu", mesh=mesh)
        tabs = _cache(b, tables, pattern, shift, "uniq")
        out.append([b.map_mate_slabs(c, n, tabs, False, 5000, 6, pattern)
                    for c, n in ((c1, l1), (c2, l2))])
    n_past = 0
    for (streams, fb), (ustreams, ufb) in zip(*out):
        np.testing.assert_array_equal(fb, ufb)
        for st, ust in zip(streams, ustreams):
            np.testing.assert_array_equal(st["cnt"], ust["cnt"])
            used = np.arange(st["pos"].shape[1])[None, :] < st["cnt"][:, None]
            used &= ~fb[:, None]
            for k in ("seed", "mm"):
                np.testing.assert_array_equal(st[k][used], ust[k][used])
            assert st["pos"].dtype == np.uint32
            np.testing.assert_array_equal(st["pos"][used],
                                          ust["pos"][used] + np.uint32(F))
            n_past += int((st["pos"][used] >= 1 << 31).sum())
    assert n_past > 0


def test_uniq_runs_do_not_move(small):
    """The uniq runs hold words and entry offsets, not positions: the
    port's bounded build gives the same runs on the shifted table, equal to
    walt_tpu's on the unshifted one (its host build over its own word-0
    keys; walt_tpu's device build casts entries to int32, so on the shifted
    table its word-0 gather of every entry >= 2^31 reads genome word 0:
    F6)."""
    genome, tables, _, _ = small
    pattern = get_pattern("3")
    _, _, dt, sdt = tables["CT00"]
    got, want = (tdi.build_uniq_device(d["pseq"], d["index"], d["counter"],
                                       pattern, chunk=1 << 14)
                 for d in (tdi.place_table(x, "cpu") for x in (sdt, dt)))
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    word0 = np.asarray(jdi.build_key_words_device(
        jnp.asarray(dt.pseq), dt.index, pattern, n_key_words=1))[:, 0]
    j = jdi.build_uniq_host(word0, dt.counter)
    assert j[3] == got[3]
    for w, t in zip(j[:3], got[:3]):
        np.testing.assert_array_equal(w, t.numpy().view(np.uint32))


# ---- against walt_tpu on the shifted inputs (last: they hold a JAX copy
# of the shifted CT00 words, ~540 MB, until the module ends) ----

@pytest.fixture(scope="module")
def jax_pseq(small):
    return jnp.asarray(small[1]["CT00"][3].pseq)


@pytest.mark.parametrize("rung", ["uniq", "key16", "3-word"])
def test_map_strand_core_shifted_matches_jax(small, jax_pseq, monkeypatch,
                                            rung):
    """The port == walt_tpu (its Pallas kernel in interpret mode) on the
    same shifted inputs, the uniq rung's runs included (walt_tpu's own
    uniq build misreads entries >= 2^31, F6)."""
    monkeypatch.setenv("WALTX_PALLAS", "1")
    genome, tables, (codes, lens), _ = small
    _, _, dt, sdt = tables["CT00"]
    pattern = get_pattern("3")
    codes, lens = codes[:160], lens[:160]
    preads = _packed(codes)
    tt, tx = _torch_tables(sdt, pattern, rung)
    got = _map_strand(sdt, pattern, rung, preads, lens, (tt, tx))
    jt, jx = _jax_tables(sdt, jax_pseq, pattern, rung, runs=tx,
                         keys_from=dt)
    want = jpipe.map_strand_core(
        jnp.asarray(preads), jnp.asarray(lens),
        jnp.int32(3 if rung == "3-word" else 5000), jnp.int32(6),
        *(jt[k] for k in _ORDER), **_strand_kw(sdt, rung), **jx)
    del jt, jx
    for name, w, t in zip(("seed", "pos", "mm", "cnt", "fallback"),
                          want, got):
        w = np.asarray(w)
        np.testing.assert_array_equal(t.numpy().astype(w.dtype), w,
                                      err_msg=name)
    assert (got[1].numpy()[got[0].numpy() >= 0] >= 1 << 31).any()
