"""walt_tpu_torch's multi-device mapping against walt_tpu's sharded programs.

walt_tpu runs on the 8-device virtual JAX CPU mesh of tests/conftest.py
(dp=4 x tp=2), the port on ``make_mesh(["cpu"] * 8, tp=2)``.  walt_tpu
splits a table into equal bucket-key ranges, the port into ranges of
about equal entry counts (reference fault F4), which moves reads' route
and worklist spills; where a test says so, results are compared where
neither side fell back (ROADMAP's parity rule), elsewhere exactly,
fallback bits included:

- ``balanced_bounds``: strictly increasing cuts, every shard non-empty and
  within one bucket of N/T entries;
- ``shard_device_table`` (uniq and key16, tp 2 and 4) at walt_tpu's equal
  ranges == walt_tpu's padded host layout; the port keeps the flags as
  uint8 bit masks where walt_tpu casts them to bool (reference fault F3);
- ``shard_and_place``'s exact-size shards == the padded host rows, placed
  once per (shard, device), under both splits;
- ``map_strand_core`` with ``key_base``, unrouted and routed (with and
  without route spills), on the uniq, key16, u32 word-0 and 3-word exact_b
  rungs, as slabs and as the ``emit_wl`` stream;
- ``merge_gathered`` and ``combine_summaries`` on random inputs;
- ``map_strand_sharded`` and ``map_single_end_sharded`` on the port's
  split, where neither side fell back; ``map_mate_sharded`` at walt_tpu's
  equal ranges, exactly (on chunks whose flat streams do not spill: F1 is
  steered around), on both mates' tables and at tp=4 too, on dp=2 x tp=4
  meshes of the same 8 devices.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walt_tpu_torch.constants import get_pattern
from walt_tpu.ops import pipeline as jpipe
from walt_tpu.ops import se_fold as jfold
from walt_tpu.parallel import sharded as jsh
from walt_tpu_torch.ops import packing
from walt_tpu_torch.ops import pipeline as tpipe
from walt_tpu_torch.ops import se_fold as tfold
from walt_tpu_torch.parallel import sharded as tsh

PATTERN = get_pattern("3")
C = jpipe.CAND_SLAB
B = 256  # reads per chunk: a multiple of dp = 4


@pytest.fixture(scope="module")
def mesh8():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    return jsh.make_mesh(jax.devices()[:8], tp=2)


@pytest.fixture(scope="module")
def tmesh():
    return tsh.make_mesh(["cpu"] * 8, tp=2)


def _reads(genome, n, seed, ag=False):
    """Packed bisulfite reads of 30-100 bp (zero codes past each length);
    ``ag``: their reverse complements, G->A reads for the GA tables."""
    from walt_tpu_torch.synth import sample_reads

    codes, _, _ = sample_reads(genome, n, 100, seed=seed)
    lens = np.random.default_rng(seed).choice(
        [100, 100, 90, 80, 45, 30], n).astype(np.int32)
    if ag:
        codes = np.ascontiguousarray((3 - codes)[:, ::-1])
    codes[np.arange(100)[None, :] >= lens[:, None]] = 0
    return packing.pack_codes_np(np.pad(codes, ((0, 0), (0, 12)))), lens


@pytest.fixture(scope="module")
def synth():
    """A 120 kbp genome, host-prepared tables (3 key words) for all four
    conversions, and reads for the C->T and G->A tables."""
    from walt_tpu.index.build import build_table
    from walt_tpu_torch.index.convert import (
        genome_from_arrays, table_from_arrays,
    )
    from walt_tpu_torch.ops.device_index import build_device_table
    from walt_tpu_torch.synth import make_genome

    genome = make_genome(120_000, seed=3)
    dts = {}
    for conv in ("CT00", "CT01", "GA10", "GA11"):
        # built by walt_tpu, handed to the port as arrays
        g, ht = build_table(genome, conv, PATTERN, verbose=False)
        g = genome_from_arrays(g.names, g.lengths, g.start_index, g.seq,
                               g.strand)
        ht = table_from_arrays(ht.counter, ht.index)
        dts[conv] = build_device_table(g, ht, PATTERN, with_key_words=True)
    return dts, _reads(genome, B, 5), _reads(genome, B, 7, ag=True)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _i32(a):
    return packing.from_np(np.ascontiguousarray(a))


#: the tp splits a shard is held to walt_tpu's or the host layout under:
#: walt_tpu's equal bucket-key ranges and the runtime's entry-balanced
#: ranges
SPLITS = {"equal": tsh.bucket_range_bounds, "balanced": tsh.balanced_bounds}


@contextlib.contextmanager
def _split(split):
    """The port's tp split replaced by ``split`` (:data:`SPLITS`)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tsh, "balanced_bounds", SPLITS[split])
        yield


@pytest.mark.parametrize("accel", ["uniq", "key16"])
@pytest.mark.parametrize("T", [2, 4])
def test_shard_device_table_matches_jax(synth, accel, T):
    dt = synth[0]["CT00"]
    want = jsh.shard_device_table(dt, T, accel=accel)
    with _split("equal"):
        got = tsh.shard_device_table(dt, T, accel=accel)
    for f in ("key_base", "counter", "index", "key_words", "uniq_counter",
              "uniq_words", "uniq_off", "pseq", "start_index"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.max_bucket_bits, got.uniq_bits) == (want.max_bucket_bits,
                                                    want.uniq_bits)
    # F3: walt_tpu's flags are bool (bit 1, the exact_b flag, is lost); the
    # port keeps the uint8 bit masks
    assert want.bucket_flagged.dtype == bool
    nbl = got.counter.shape[1] - 1
    np.testing.assert_array_equal(got.bucket_flagged,
                                  dt.bucket_flagged.reshape(T, nbl))
    np.testing.assert_array_equal(got.bucket_flagged != 0,
                                  want.bucket_flagged)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("accel", ["uniq", "key16"])
def test_shard_and_place_is_the_host_layout(synth, tmesh, accel, split):
    dt = synth[0]["CT01"]
    kb = SPLITS[split](dt.counter, 2)[0]
    with _split(split):
        st = tsh.shard_device_table(dt, 2, accel=accel)
        grid, ubits = tsh.shard_and_place(dt, tmesh, PATTERN, accel=accel)
    assert ubits == st.uniq_bits
    assert len(grid) == 4 and all(len(r) == 2 for r in grid)
    for t in range(2):
        sh = grid[0][t]
        assert all(row[t] is sh for row in grid)  # one copy per device
        assert sh["pseq"] is grid[0][0]["pseq"]
        assert sh["key_base"] == int(st.key_base[t]) == kb[t]
        n, nbl = int(st.counter[t, -1]), int(kb[t + 1] - kb[t])
        np.testing.assert_array_equal(_np(sh["counter"]).view(np.uint32),
                                      st.counter[t, :nbl + 1])
        np.testing.assert_array_equal(_np(sh["index"]).view(np.uint32),
                                      st.index[t, :n])
        np.testing.assert_array_equal(_np(sh["bucket_flagged"]),
                                      st.bucket_flagged[t, :nbl])
        if accel == "key16":
            np.testing.assert_array_equal(
                _np(sh["key_words"]).view(np.uint16), st.key_words[t, :n])
            continue
        u = int(st.uniq_counter[t, -1])
        for k, want in (("uniq_counter", st.uniq_counter[t, :nbl + 1]),
                        ("uniq_words", st.uniq_words[t, :u]),
                        ("uniq_off", st.uniq_off[t, :u + 1])):
            np.testing.assert_array_equal(_np(sh[k]).view(np.uint32), want,
                                          err_msg=k)


#: (accel of the host shards, key words used, uniq runs used, exact_b)
RUNGS = {"uniq": ("uniq", None, True, False),
         "key16": ("key16", "key16", False, False),
         "word0": ("uniq", 1, False, False),
         "exact_b": ("uniq", 3, False, True)}


def _shard_args(st, s, rung):
    """One shard's table arguments of map_strand_core, as numpy arrays."""
    _, kw, use_uniq, _ = RUNGS[rung]
    if kw == "key16":
        key_words = st.key_words[s]
    elif kw is None:
        key_words = np.zeros((1, 1), np.uint32)
    else:
        key_words = np.ascontiguousarray(st.key_words[s][:, :kw])
    table = [st.pseq, st.counter[s], st.index[s], key_words, st.start_index,
             st.bucket_flagged[s]]
    uniq = ([st.uniq_words[s], st.uniq_off[s], st.uniq_counter[s]]
            if use_uniq else [None] * 3)
    return table, uniq


def _to_torch(a):
    if a is None:
        return None
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16))
    if a.dtype == np.uint8:
        return torch.from_numpy(a)
    return _i32(a)


@pytest.mark.parametrize("route", [0, 2, 8], ids=["key_base", "routed",
                                                  "route_spill"])
@pytest.mark.parametrize("rung", list(RUNGS))
def test_map_strand_core_sharded_matches_jax(synth, rung, route):
    """One tp=2 shard at a time; route 8 on a 2-way split makes the routed
    capacity K smaller than the owned pairs, so reads spill the route."""
    dt = synth[0]["CT00"]
    preads, lens = synth[1]
    st = tsh.shard_device_table(dt, 2, accel=RUNGS[rung][0])
    exact_b = RUNGS[rung][3]
    spilled = 0
    for s in range(2):
        table, uniq = _shard_args(st, s, rung)
        kw = dict(pattern_name="3", ag_wildcard=False,
                  search_bits=st.max_bucket_bits, verify_slab=8,
                  wl_factor=1.5, exact_b=exact_b,
                  uniq_bits=st.uniq_bits if uniq[0] is not None else 0,
                  key_base=int(st.key_base[s]), tp_route=route)
        b = 3 if exact_b else 5000
        for emit_wl in (False, True):
            want = jpipe.map_strand_core(
                jnp.asarray(preads), jnp.asarray(lens), jnp.int32(b),
                jnp.int32(6), *(jnp.asarray(a) for a in table),
                uniq_words=None if uniq[0] is None else jnp.asarray(uniq[0]),
                uniq_off=None if uniq[1] is None else jnp.asarray(uniq[1]),
                uniq_counter=(None if uniq[2] is None
                              else jnp.asarray(uniq[2])),
                emit_wl=emit_wl, **kw)
            got = tpipe.map_strand_core(
                _i32(preads), torch.from_numpy(lens), b, 6,
                *(_to_torch(a) for a in table), uniq_words=_to_torch(uniq[0]),
                uniq_off=_to_torch(uniq[1]), uniq_counter=_to_torch(uniq[2]),
                emit_wl=emit_wl, **kw)
            if emit_wl:
                keep = _np(want[0][5])
                np.testing.assert_array_equal(_np(got[0][5]), keep)
                for name, j, t in zip(("wl_read", "col", "pos", "mm",
                                       "shift"), want[0], got[0]):
                    np.testing.assert_array_equal(
                        _np(t)[keep].astype(np.int64),
                        _np(j)[keep].astype(np.int64), err_msg=name)
                want, got = want[1:], got[1:]
            for j, t in zip(want, got):
                np.testing.assert_array_equal(_np(t).astype(np.int64),
                                              _np(j).astype(np.int64))
        spilled += int(_np(got[-1]).sum())
        assert int(_np(got[0]).sum()) > 0
    if route == 8:
        assert spilled > B // 4  # the route capacity spilled


def _random_slabs(rng, T, Bl):
    """Per-shard seed-major slabs: each (shard, read) keeps up to C
    candidates with ascending seeds; -1 seeds past the count."""
    cs = np.full((T, Bl, C), -1, np.int8)
    cp = np.zeros((T, Bl, C), np.uint32)
    cm = np.zeros((T, Bl, C), np.int32)
    for t in range(T):
        for r in range(Bl):
            k = int(rng.integers(0, C + 1) * (rng.random() < 0.7))
            cs[t, r, :k] = np.sort(rng.integers(0, 3, k))
            cp[t, r, :k] = rng.integers(0, 1 << 32, k, dtype=np.uint32)
            cm[t, r, :k] = rng.integers(0, 7, k)
    return cs, cp, cm, rng.random(Bl) < 0.1


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_gathered_matches_jax(seed):
    cs, cp, cm, fb = _random_slabs(np.random.default_rng(seed), 2, 48)
    want = jsh.merge_gathered(jnp.asarray(cs), jnp.asarray(cp),
                              jnp.asarray(cm), jnp.asarray(fb), C, 3)
    got = tsh.merge_gathered(torch.from_numpy(cs),
                             torch.from_numpy(cp.astype(np.int64)),
                             torch.from_numpy(cm), torch.from_numpy(fb), C, 3)
    for j, t in zip(want, got):
        np.testing.assert_array_equal(_np(t).astype(np.int64),
                                      _np(j).astype(np.int64))
    assert _np(got[4]).sum() > fb.sum()  # some reads overflowed the slab


def test_combine_summaries_matches_jax():
    rng = np.random.default_rng(3)
    parts = []
    for _ in range(3):
        has = rng.random((40, 3)) < 0.3
        parts.append(dict(
            seg_min=np.where(has, rng.integers(0, 7, (40, 3)),
                             1 << 30).astype(np.int32),
            inner_t=rng.integers(0, 5, (40, 3)).astype(np.int32),
            first_pos=rng.integers(0, 1 << 32, (40, 3), dtype=np.uint32),
            last_pos=rng.integers(0, 1 << 32, (40, 3), dtype=np.uint32),
            has=has))
    want = jfold.combine_summaries(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in parts])
    got = tfold.combine_summaries([
        {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                             else v) for k, v in p.items()} for p in parts])
    for k in want:
        np.testing.assert_array_equal(_np(got[k]).astype(np.int64),
                                      _np(want[k]).astype(np.int64), err_msg=k)


def _placed(dts, convs, mesh8, tmesh, accel, equal=False):
    """walt_tpu's and the port's placed shards of each table, and their
    search / uniq bits; ``equal``: the port's at walt_tpu's equal bucket-key
    ranges, else at its own split."""
    jt, tt, bits, ubits = [], [], [], []
    for conv in convs:
        dt = dts[conv]
        dev, ub = jsh.shard_and_place(dt, mesh8, accel=accel,
                                      free_input=False)
        with _split("equal" if equal else "balanced"):
            grid, ub_t = tsh.shard_and_place(dt, tmesh, PATTERN,
                                             accel=accel)
        assert ub_t == ub
        jt.append(dev)
        tt.append(grid)
        bits.append(dt.max_bucket_bits)
        ubits.append(ub)
    return jt, tt, tuple(bits), tuple(ubits)


@pytest.mark.parametrize("accel", ["uniq", "key16"])
def test_map_strand_sharded_matches_jax(synth, mesh8, tmesh, accel):
    dts, (preads, lens), _ = synth
    (jt,), (tt,), (bits,), (ubits,) = _placed(dts, ["CT00"], mesh8, tmesh,
                                              accel)
    kw = dict(pattern_name="3", ag_wildcard=False, search_bits=bits,
              verify_slab=8, cand_slab=C, wl_factor=1.5, uniq_bits=ubits)
    want = jsh.map_strand_sharded(
        jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000), jnp.int32(6),
        jt["key_base"], jt["counter"], jt["index"], jt["key_words"],
        jt["bucket_flagged"], jt["pseq"], jt["start_index"], mesh=mesh8,
        uniq_counter=jt["uniq_counter"], uniq_words=jt["uniq_words"],
        uniq_off=jt["uniq_off"], **kw)
    got = tsh.map_strand_sharded(_i32(preads), torch.from_numpy(lens), 5000,
                                 6, tt, mesh=tmesh, **kw)
    ok = ~(_np(got[4]) | _np(want[4]))
    for j, t in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(_np(t).astype(np.int64)[ok],
                                      _np(j).astype(np.int64)[ok])
    # the compared reads are all but walt_tpu's host reads and the port's,
    # which are no more (its split spills fewer routed pairs)
    fell = int(_np(got[4]).sum()), int(_np(want[4]).sum())
    assert fell[0] <= fell[1], fell
    assert _np(got[3]).sum() > 0


def test_map_single_end_sharded_matches_jax(synth, mesh8, tmesh):
    dts, (preads, lens), _ = synth
    jt, tt, bits, ubits = _placed(dts, ["CT00", "CT01"], mesh8, tmesh, "uniq")
    for seeds in ((0,), None):
        kw = dict(pattern_name="3", ag_wildcard=False, search_bits=bits,
                  verify_slab=8, cand_slab=C, seeds=seeds, wl_factor=1.5,
                  uniq_bits=ubits)
        want = jsh.map_single_end_sharded(
            jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000),
            jnp.int32(6), tuple(jt), mesh=mesh8, **kw)
        got = tsh.map_single_end_sharded(
            _i32(preads), torch.from_numpy(lens), 5000, 6, tt, mesh=tmesh,
            **kw)
        got, want = _np(got), _np(want).astype(np.int64)
        ok = ((got[:, 2] | want[:, 2]) & 1) == 0  # the fallback bit
        np.testing.assert_array_equal(got[ok], want[ok])
        # the compared reads are all but walt_tpu's host reads and the port's,
        # which are no more (its split spills fewer routed pairs)
        fell = int((got[:, 2] & 1).sum()), int((want[:, 2] & 1).sum())
        assert fell[0] <= fell[1], fell


@pytest.fixture(scope="module")
def meshes_tp4():
    """walt_tpu's 8 virtual devices as dp=2 x tp=4, and the port's."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    return (jsh.make_mesh(jax.devices()[:8], tp=4),
            tsh.make_mesh(["cpu"] * 8, tp=4))


@pytest.mark.parametrize("mate", ["ga", "ct"])
@pytest.mark.parametrize("tp", [2, 4])
def test_map_mate_sharded_matches_jax(synth, mesh8, tmesh, meshes_tp4, tp,
                                      mate):
    """Mate 2 on the G->A tables and mate 1 on the C->T tables, at tp=2
    (dp=4) and at tp=4 (dp=2, the hg19 PE layout)."""
    from walt_tpu_torch.ops import pe_map as tpe

    jmesh, pmesh = (mesh8, tmesh) if tp == 2 else meshes_tp4
    dts, ct_reads, ga_reads = synth
    ag = mate == "ga"
    preads, lens = ga_reads if ag else ct_reads
    convs = ["GA10", "GA11"] if ag else ["CT00", "CT01"]
    jt, tt, bits, ubits = _placed(dts, convs, jmesh, pmesh, "uniq",
                                  equal=True)
    kw = dict(pattern_name="3", ag_wildcard=ag, search_bits=bits,
              verify_slab=tpe.VERIFY_SLAB, cand_slab=C,
              wl_factor=tpe.WL_FACTOR, flat_factor=tpe.FLAT_FACTOR,
              uniq_bits=ubits)
    jmeta, jflat = jsh.map_mate_sharded(
        jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000),
        jnp.int32(6), tuple(jt), mesh=jmesh, **kw)
    tmeta, tflat = tsh.map_mate_sharded(
        _i32(preads), torch.from_numpy(lens), 5000, 6, tt, mesh=pmesh, **kw)
    jmeta = np.asarray(jmeta)
    T, dp = pmesh.shape["tp"], pmesh.shape["dp"]
    assert (T, dp) == (jmesh.shape["tp"], jmesh.shape["dp"]) == (tp, 8 // tp)
    assert jmeta.shape == (T, B) and np.asarray(jflat).shape == (
        T, tpe.FLAT_FACTOR * B, 2)
    # F1 steered around: no dp segment's stream spills its capacity
    counts = (jmeta & 0xFF).astype(np.int64) + ((jmeta >> 8) & 0xFF)
    assert counts.reshape(T, dp, -1).sum(-1).max() <= tpe.FLAT_FACTOR * B // dp
    assert counts.sum() > 0
    np.testing.assert_array_equal(tmeta.numpy().view(np.uint32), jmeta)
    np.testing.assert_array_equal(tflat.numpy().view(np.uint32),
                                  np.asarray(jflat))
