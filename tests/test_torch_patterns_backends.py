"""Seed patterns 5 and 7 through the port's backends, against walt_tpu's.

The data of ``tests/test_torch_patterns.py`` (the port's CLI index of a
small repetitive genome, SE reads and pairs); this file holds the
comparisons with walt_tpu's JAX programs, which compile for each pattern:

- (c) ``TorchBackend.map_strand`` == walt_tpu's ``JaxBackend`` and both
  ``NumpyBackend`` s, A/G wildcard off and on (the counterpart of
  ``tests/test_patterns.py``);
- (d) ``map_single_end`` and ``map_mate_slabs`` == ``JaxBackend`` 's where
  neither side fell back, with the same fallback masks;
- the pattern is part of a cached step's key (``ops/graphs``);
- (e) a tp = 2 sharded SE step under pattern 7 == walt_tpu's on its
  8-device virtual mesh where neither side fell back (the port splits a
  table by entry count, walt_tpu by equal key ranges: F4).

Exact equality throughout, on the reads each comparison holds.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_patterns import (  # noqa: F401 (the fixture)
    SUFFIXES, _packed_batch, _tables, datasets,
)
from walt_tpu_torch.constants import get_pattern


# ---- (c) map_strand ------------------------------------------------------

@pytest.mark.parametrize("ag", [False, True], ids=["ct", "ag"])
@pytest.mark.parametrize("name", ["5", "7"])
def test_map_strand_matches_walt_tpu(datasets, name, ag):
    from walt_tpu.constants import get_pattern as jpattern
    from walt_tpu.core.backends import NumpyBackend as JNumpy
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.index import io_walt as jio
    from walt_tpu_torch.core.backends import NumpyBackend
    from walt_tpu_torch.core.torch_backend import TorchBackend

    data, pattern = datasets(name), get_pattern(name)
    codes, lens = _packed_batch(data["reads"])
    suffix = "_CT00"
    if ag:  # G->A reads (reverse complements) on a G->A table
        suffix = "_GA10"
        for i, n in enumerate(lens.tolist()):
            codes[i, :n] = 3 - codes[i, :n][::-1]
    g, ht = _tables(data["index"])[suffix]
    jm, _ = jio.read_head(data["index"])
    jg, jht = jio.read_table(data["index"] + suffix, jm)
    args = (ag, 5000, 6)
    got = TorchBackend(device="cpu", chunk=256, small_chunk=256).map_strand(
        codes, lens, g, ht, *args, pattern)
    want = JaxBackend(chunk=256, small_chunk=256).map_strand(
        codes, lens, jg, jht, *args, jpattern(name))
    oracle = JNumpy().map_strand(codes, lens, jg, jht, *args, jpattern(name))
    ours = NumpyBackend().map_strand(codes, lens, g, ht, *args, pattern)

    def norm(streams):
        return [[tuple(int(x) for x in c) for c in s] for s in streams]

    assert norm(got) == norm(want) == norm(oracle) == norm(ours)
    assert sum(map(len, got)) > 50


# ---- (d) map_single_end / map_mate_slabs --------------------------------

@pytest.mark.parametrize("name", ["5", "7"])
def test_map_single_end_and_mate_slabs_match_jax(datasets, name):
    """Zero codes past each read's end, so walt_tpu's device reads what the
    port reads on every read, 23-24 bp ones included."""
    from walt_tpu.constants import get_pattern as jpattern
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.index import io_walt as jio
    from walt_tpu_torch.core.torch_backend import TorchBackend

    data, pattern = datasets(name), get_pattern(name)
    codes, lens = _packed_batch(data["reads"])
    if name == "7":
        sc, sl = _packed_batch(data["short"])
        L = max(codes.shape[1], sc.shape[1])
        codes = np.concatenate([np.pad(codes, ((0, 0), (0, L - codes.shape[1]))),
                                np.pad(sc, ((0, 0), (0, L - sc.shape[1])))])
        lens = np.concatenate([lens, sl])
    tabs = _tables(data["index"])
    jm, _ = jio.read_head(data["index"])
    jtabs = {s: jio.read_table(data["index"] + s, jm) for s in SUFFIXES}
    # one chunk shape, and no seed-0 phase: one device program per step
    tb = TorchBackend(device="cpu", chunk=512, small_chunk=512)
    jb = JaxBackend(chunk=512, small_chunk=512)
    tb._seed0_rate = jb._seed0_rate = 0.0

    got = tb.map_single_end(codes, lens, [tabs["_CT00"], tabs["_CT01"]],
                            5000, 6, pattern)
    want = jb.map_single_end(codes, lens, [jtabs["_CT00"], jtabs["_CT01"]],
                             5000, 6, jpattern(name))
    fb = got[4]
    np.testing.assert_array_equal(fb, want[4])
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a[~fb], b[~fb])
    assert 0.3 < (~fb[lens >= pattern.min_read_len]).mean()

    for mate, (s0, s1) in ((1, ("_CT00", "_CT01")), (2, ("_GA10", "_GA11"))):
        mc, ml = _packed_batch(data["pairs"][mate - 1])
        streams, mfb = tb.map_mate_slabs(mc, ml, [tabs[s0], tabs[s1]],
                                         mate == 2, 5000, 6, pattern)
        jstreams, jfb = jb.map_mate_slabs(mc, ml, [jtabs[s0], jtabs[s1]],
                                          mate == 2, 5000, 6, jpattern(name))
        np.testing.assert_array_equal(mfb, jfb)
        for sa, sb in zip(streams, jstreams):
            for k in ("seed", "pos", "mm", "cnt"):
                np.testing.assert_array_equal(sa[k][~mfb], sb[k][~mfb],
                                              err_msg=k)
        assert (~mfb).mean() > 0.3


def test_pattern_is_part_of_the_step_key(datasets):
    """One table, one chunk: the strand step under pattern 3 and under
    pattern 7 are two cached steps (the pattern is a static argument of
    walt_tpu's jit sites), each equal to its eager step."""
    from walt_tpu_torch.ops import device_index as tdi
    from walt_tpu_torch.ops import packing, pipeline
    from walt_tpu_torch.ops.graphs import StepCache

    data = datasets("7")
    g, ht = _tables(data["index"])["_CT00"]
    dt = tdi.build_device_table(g, ht, get_pattern("7"), with_key_words=True)
    t = tdi.place_table(dt, "cpu")
    tables = [t[k] for k in ("pseq", "counter", "index", "key_words",
                             "start_index", "bucket_flagged")]
    codes, lens = _packed_batch(data["reads"])
    L = -(-codes.shape[1] // 16) * 16
    preads = packing.from_np(packing.pack_codes_np(
        np.pad(codes, ((0, 0), (0, L - codes.shape[1])))))
    lens = torch.from_numpy(lens)
    cache, first = StepCache(), {}
    for name in ("3", "7", "3"):
        kw = dict(pattern_name=name, ag_wildcard=False,
                  search_bits=dt.max_bucket_bits)
        got = cache.run(pipeline.map_strand_core, (preads, lens), 5000, 6,
                        *tables, **kw)
        want = pipeline.map_strand_core(preads, lens, 5000, 6, *tables, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        first.setdefault(name, got)
        assert got[0] is first[name][0]  # the key's own outputs
    assert len(cache) == 2
    assert not torch.equal(first["3"][3], first["7"][3])


# ---- (e) the tp = 2 mesh ------------------------------------------------

def test_sharded_se_pattern7_matches_walt_tpu(datasets):
    import jax

    import jax.numpy as jnp

    from walt_tpu.parallel import sharded as jsh
    from walt_tpu_torch.ops import device_index as tdi
    from walt_tpu_torch.ops import packing
    from walt_tpu_torch.parallel import sharded as tsh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    pattern = get_pattern("7")
    data = datasets("7")
    tabs = _tables(data["index"])
    sc, sl = _packed_batch(data["short"])
    codes, lens = _packed_batch(data["reads"])
    B = 256  # a multiple of dp = 4
    L = 160
    codes = np.concatenate([np.pad(c, ((0, 0), (0, L - c.shape[1])))
                            for c in (codes, sc)])[:B]
    lens = np.concatenate([lens, sl])[:B].astype(np.int32)
    preads = packing.pack_codes_np(codes)
    mesh8 = jsh.make_mesh(jax.devices()[:8], tp=2)
    tmesh = tsh.make_mesh(["cpu"] * 8, tp=2)
    jt, tt, bits, ubits = [], [], [], []
    for s in ("_CT00", "_CT01"):
        dt = tdi.build_device_table(*tabs[s], pattern, with_key_words=True)
        dev, ub = jsh.shard_and_place(dt, mesh8, accel="uniq",
                                      free_input=False)
        grid, ub_t = tsh.shard_and_place(dt, tmesh, pattern, accel="uniq")
        assert ub_t == ub
        jt.append(dev)
        tt.append(grid)
        bits.append(dt.max_bucket_bits)
        ubits.append(ub)
    kw = dict(pattern_name="7", ag_wildcard=False, search_bits=tuple(bits),
              verify_slab=8, cand_slab=32, wl_factor=1.5,
              uniq_bits=tuple(ubits))
    want = jsh.map_single_end_sharded(
        jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000),
        jnp.int32(6), tuple(jt), mesh=mesh8, **kw)
    got = tsh.map_single_end_sharded(
        packing.from_np(preads), torch.from_numpy(lens), 5000, 6, tt,
        mesh=tmesh, **kw)
    got, want = np.asarray(got), np.asarray(want).astype(np.int64)
    ok = ((got[:, 2] | want[:, 2]) & 1) == 0  # the fallback bit
    np.testing.assert_array_equal(got[ok], want[ok])
    # the compared reads are all but walt_tpu's host reads and the port's,
    # which are no more (its split spills fewer routed pairs)
    fell = int((got[:, 2] & 1).sum()), int((want[:, 2] & 1).sum())
    assert fell[0] <= fell[1], fell
