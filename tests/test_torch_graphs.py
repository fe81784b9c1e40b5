"""The step cache (``walt_tpu_torch/ops/graphs``): walt_tpu's jitted steps
as CUDA graphs, and its CPU stand-in.

On the CPU the cache runs each step and copies its result into the tensors
the key's first call returned, so these tests see the aliasing of a real
graph: a caller that does not copy a step's outputs out before the next
step reads the next chunk's results.

- keys: equal static arguments reuse an entry; a change in any one of
  walt_tpu's ``static_argnames`` (read from its ``jax.jit`` sites), in an
  input's shape, in ``b`` or ``max_mm``, in the lane or in the identity of
  a table tensor makes a new one; ``drop`` forgets the entries of the
  tensors it is given; a stage recorder is refused;
- ``TorchBackend.free_tables``, the ``wide_kw`` rebuild and the key-word
  rebuild drop the steps of the tables they free;
- the cached SE and PE steps over several chunks of one shape equal
  walt_tpu's jitted ``map_single_end_device`` and ``map_mate_device`` (its
  Pallas verify kernel in interpret mode, as its own tests run it) chunk
  for chunk, and the backend's multi-chunk SE, PE and strand batches equal
  walt_tpu's ``JaxBackend`` and ``NumpyBackend`` (the CLI's output byte for
  byte);
- the sharded steps' dp rows (dp = 2 x tp = 2 and dp = 4) replay their own
  cached parts, one lane per row, and equal walt_tpu's sharded programs on
  two chunks of one shape;
- a second call of a step makes no tensor from host data: the pass's
  constant tables are made once per device, pattern, seeds and W.

Exact equality throughout: every output is an integer.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pe import (  # noqa: F401  (fixtures)
    _packed, _table_pair, both_strand_reads, mates, pe_tables,
)
from test_torch_sharded import C, _i32, _np, _placed, synth  # noqa: F401
from walt_tpu.ops import pe_map as jpe
from walt_tpu.ops import se_fold as jfold
from walt_tpu.parallel import sharded as jsh
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.core.torch_backend import TorchBackend
from walt_tpu_torch.ops import packing
from walt_tpu_torch.ops import pe_map as tpe
from walt_tpu_torch.ops import se_fold as tfold
from walt_tpu_torch.ops import stages as st
from walt_tpu_torch.ops.graphs import StepCache
from walt_tpu_torch.parallel import sharded as tsh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATTERN = get_pattern("3")


def _static_argnames(path: str, name: str) -> tuple:
    """The ``static_argnames`` of walt_tpu's ``jax.jit`` site ``name``."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            for dec in node.decorator_list:
                for kw in getattr(dec, "keywords", ()):
                    if kw.arg == "static_argnames":
                        return tuple(ast.literal_eval(kw.value))
    raise LookupError(f"{path}: no jit site {name}")


SE_STATIC = _static_argnames("walt_tpu/ops/se_fold.py",
                             "map_single_end_device")
PE_STATIC = _static_argnames("walt_tpu/ops/pe_map.py", "map_mate_device")
STRAND_STATIC = _static_argnames("walt_tpu/ops/pipeline.py",
                                 "map_strand_device")
#: a value for each static argument, and another one
BASE = dict(pattern_name="3", ag_wildcard=False, search_bits=(20, 20),
            verify_slab=8, cand_slab=32, seeds=None, wl_factor=1.5,
            exact_b=False, flat_factor=12, uniq_bits=(10, 10),
            full_mask=True)
OTHER = dict(pattern_name="5", ag_wildcard=True, search_bits=(21, 20),
             verify_slab=16, cand_slab=64, seeds=(0,), wl_factor=3,
             exact_b=True, flat_factor=8, uniq_bits=(0, 0), full_mask=False)


def _fake_step(preads, lens, b, max_mm, tables, **kw):
    """A step with the SE / PE signature: cheap, and different per chunk."""
    return preads.sum(1) * b + lens * max_mm + tables[0]["pseq"].sum()


def _chunk(seed, n=8):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 1 << 30, (n, 7)).astype(
                np.int32)),
            torch.from_numpy(rng.integers(30, 101, n).astype(np.int32)))


def _tables(fill=3):
    return ({"pseq": torch.full((5,), fill), "key_base": 0},)


def test_walt_tpu_static_argnames_are_the_ports_keywords():
    """Every static argument of walt_tpu's jit sites is a keyword of the
    port's step, so it is part of a cached step's key."""
    import inspect

    from walt_tpu_torch.ops import pipeline as tpipe

    for names, fn in ((SE_STATIC, tfold.map_single_end_device),
                      (PE_STATIC, tpe.map_mate_device),
                      (STRAND_STATIC, tpipe.map_strand_core)):
        params = inspect.signature(fn).parameters
        assert set(names) <= set(params), fn.__name__
    assert set(SE_STATIC) | set(PE_STATIC) <= set(BASE) == set(OTHER)


def test_equal_static_arguments_reuse_the_entry():
    cache = StepCache()
    tables = _tables()
    x1, x2 = _chunk(1), _chunk(2)
    out1 = cache.run(_fake_step, x1, 5000, 6, tables, **BASE)
    first = out1.clone()
    # equal arguments in new containers: the same key
    out2 = cache.run(_fake_step, x2, 5000, 6, (dict(tables[0]),),
                     **dict(BASE))
    assert len(cache) == 1
    assert out2 is out1  # the graph's outputs, overwritten by the replay
    assert torch.equal(out2, _fake_step(*x2, 5000, 6, tables))
    assert torch.equal(first, _fake_step(*x1, 5000, 6, tables))
    assert not torch.equal(first, out2)


@pytest.mark.parametrize("change", sorted(set(SE_STATIC) | set(PE_STATIC))
                         + ["shape", "dtype", "table", "b", "max_mm", "lane",
                            "fn"])
def test_a_change_makes_a_new_entry(change):
    cache = StepCache()
    tables = _tables()
    x = _chunk(1)
    cache.run(_fake_step, x, 5000, 6, tables, **BASE)
    args, kw, lane, fn = [x, 5000, 6, tables], dict(BASE), 0, _fake_step
    if change in OTHER:
        kw[change] = OTHER[change]
    elif change == "shape":
        args[0] = _chunk(1, n=16)
    elif change == "dtype":
        args[0] = (x[0], x[1].to(torch.int64))
    elif change == "table":
        args[3] = _tables()  # equal values, another tensor
    elif change == "b":
        args[1] = 12
    elif change == "max_mm":
        args[2] = 2
    elif change == "lane":
        lane = 1
    else:
        def fn(*a, **k):
            return _fake_step(*a, **k)
    cache.run(fn, *args, lane=lane, **kw)
    assert len(cache) == 2
    cache.run(fn, *args, lane=lane, **kw)
    assert len(cache) == 2


def test_drop_forgets_the_entries_of_its_tensors():
    cache = StepCache()
    a, b = _tables(1), _tables(2)
    cache.run(_fake_step, _chunk(1), 5000, 6, a, **BASE)
    cache.run(_fake_step, _chunk(1), 5000, 6, b, **BASE)
    cache.run(_fake_step, _chunk(1, n=4), 5000, 6, a, **BASE)
    assert len(cache) == 3
    assert cache.drop([a[0]["pseq"]]) == 2
    assert len(cache) == 1
    assert cache.drop([torch.zeros(1)]) == 0
    cache.clear()
    assert len(cache) == 0


def test_a_stage_recorder_runs_the_step_itself():
    with pytest.raises(ValueError, match="stage recorder"):
        StepCache().run(_fake_step, _chunk(1), 5000, 6, _tables(),
                        stages=st.StageLog(), **BASE)


def _resident_ids(backend):
    return {id(t) for e in backend.graphs._entries.values()
            for t in e.resident}


def _table_tensors(backend):
    return [v for entry in backend._tables.values()
            for v in entry[1].values() if torch.is_tensor(v)]


@pytest.mark.parametrize("rebuild", ["wide_kw", "key_words"])
def test_rebuild_and_free_tables_drop_their_steps(monkeypatch, pe_tables,
                                                  mates, rebuild):
    """An SE run caches steps on the CT tables; a PE run's ``wide_kw``
    rebuild of a key16 table (or a -b below the slabs, which needs 3 key
    words) replaces the tables and drops their steps; ``free_tables``
    drops every step."""
    if rebuild == "wide_kw":
        monkeypatch.setenv("WALTX_KEY_RUNG", "key16")
    codes, lens = (x[:96] for x in mates[0])
    backend = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    backend.map_single_end(codes, lens, pe_tables[0], 5000, 6, PATTERN)
    old = _table_tensors(backend)
    assert len(backend.graphs) and _resident_ids(backend) & {id(t)
                                                            for t in old}
    if rebuild == "wide_kw":
        assert set(backend.rungs.values()) == {"key16"}
        backend.map_mate_slabs(codes, lens, pe_tables[0], False, 5000, 6,
                               PATTERN)
    else:
        backend.map_single_end(codes, lens, pe_tables[0], 12, 6, PATTERN)
    new = _table_tensors(backend)
    assert not {id(t) for t in old} & {id(t) for t in new}  # rebuilt
    assert len(backend.graphs)
    assert not _resident_ids(backend) & {id(t) for t in old}
    assert _resident_ids(backend) & {id(t) for t in new}
    backend.free_tables()
    assert len(backend.graphs) == 0


def _ct_step_args(pe_tables, ag):
    pairs = [_table_pair(g, ht, "uniq") for g, ht in pe_tables[ag]]
    return (tuple(p[0] for p in pairs), tuple(p[1] for p in pairs),
            dict(pattern_name="3", ag_wildcard=ag,
                 search_bits=tuple(p[2] for p in pairs),
                 uniq_bits=tuple(p[3] for p in pairs), cand_slab=C))


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_cached_steps_match_jitted_walt_tpu_chunk_for_chunk(
        monkeypatch, pe_tables, both_strand_reads, mode):
    """Three 32-read chunks through one cached step: the graph's outputs
    are the same tensors each call, and each chunk's copy equals walt_tpu's
    jitted step on that chunk."""
    monkeypatch.setenv("WALTX_PALLAS", "1")  # walt_tpu runs its K1 kernel
    ag = mode == "pe"
    codes, lens = both_strand_reads[ag]
    preads = _packed(codes)
    jt, tt, kw = _ct_step_args(pe_tables, ag)
    if mode == "se":
        kw.update(verify_slab=8, wl_factor=1.5)
        jstep, tstep = jfold.map_single_end_device, tfold.map_single_end_device
    else:
        kw.update(verify_slab=tpe.VERIFY_SLAB, wl_factor=tpe.WL_FACTOR,
                  flat_factor=tpe.FLAT_FACTOR)
        jstep, tstep = jpe.map_mate_device, tpe.map_mate_device
    cache = StepCache()
    first, copies = {}, []
    for a in range(0, 96, 32):
        pr, ln = preads[a:a + 32], lens[a:a + 32]
        fm = TorchBackend._full_mask(ln, PATTERN)
        out = cache.run(tstep, (packing.from_np(pr), torch.from_numpy(ln)),
                        5000, 6, tt, full_mask=fm, **kw)
        out = out if isinstance(out, tuple) else (out,)
        # one entry per full_mask value, whose outputs every call returns
        assert all(o is f for o, f in zip(out, first.setdefault(fm, out)))
        copies.append(tuple(o.clone() for o in out))
        want = jstep(jnp.asarray(pr), jnp.asarray(ln), jnp.int32(5000),
                     jnp.int32(6), jt, full_mask=fm, **kw)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(copies[-1], want):
            g = g.numpy()
            g = g.view(np.uint32) if g.dtype == np.int32 else g
            np.testing.assert_array_equal(g.astype(np.int64),
                                          np.asarray(w).astype(np.int64))
    assert len(cache) == len(first)
    assert not torch.equal(copies[0][0], copies[1][0])


def _cli_out(tmp_path, name, argv, main):
    out = str(tmp_path / name)
    assert main([*argv, "-o", out]) in (0, None)
    with open(out) as a, open(out + ".mapstats") as b:
        return a.read(), b.read()


def _small_chunks(monkeypatch):
    """The torch CLI's backend on 32- and 64-read chunks (several chunks of
    one shape per batch); returns the backends it made."""
    from walt_tpu_torch.core import backends

    made = []

    def get_backend(name, **kw):
        made.append(TorchBackend(chunk=64, small_chunk=32, **kw))
        return made[-1]

    monkeypatch.setattr(backends, "get_backend", get_backend)
    return made


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_cli_on_cached_steps_equals_numpy_backend(tmp_path, monkeypatch,
                                                  my_index, se_fastq,
                                                  pe_fastq, mode):
    """The port's CLI on multi-chunk batches (every chunk's step a cached
    step whose outputs the next chunk overwrites) writes NumpyBackend's
    output byte for byte."""
    from walt_tpu.cli import main_map
    from walt_tpu_torch import cli as tcli

    reads = (["-r", se_fastq] if mode == "se" else
             ["-1", pe_fastq[0], "-2", pe_fastq[1]])
    want = _cli_out(tmp_path, "numpy.mr", ["-i", my_index, *reads,
                                           "--backend", "numpy"], main_map)
    made = _small_chunks(monkeypatch)
    got = _cli_out(tmp_path, "torch.mr", ["-i", my_index, *reads, "--device",
                                          "cpu"], tcli.main)
    assert made and len(made[0].graphs)
    assert got == want


def test_map_single_end_and_mate_slabs_equal_jax_backend(mates, pe_tables):
    """Multi-chunk SE and PE batches through the backend's cached steps
    equal walt_tpu's JaxBackend (its jitted steps), fallback bits
    included."""
    from walt_tpu.core.jax_backend import JaxBackend

    codes, lens = mates[0]
    tb = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    jb = JaxBackend(chunk=64, small_chunk=32)
    got = tb.map_single_end(codes, lens, pe_tables[0], 5000, 6, PATTERN)
    want = jb.map_single_end(codes, lens, pe_tables[0], 5000, 6, PATTERN)
    np.testing.assert_array_equal(got[4], want[4])
    ok = ~got[4]
    assert ok.mean() > 0.5
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g[ok], np.asarray(w)[ok])
    for mate, ag in ((0, False), (1, True)):
        codes, lens = mates[mate]
        streams, fb = tb.map_mate_slabs(codes, lens, pe_tables[mate], ag,
                                        5000, 6, PATTERN)
        jstreams, jfb = jb.map_mate_slabs(codes, lens, pe_tables[mate], ag,
                                          5000, 6, PATTERN)
        np.testing.assert_array_equal(fb, jfb)
        for s, j in zip(streams, jstreams):
            for k in ("seed", "pos", "mm", "cnt"):
                np.testing.assert_array_equal(s[k][~fb], j[k][~fb])
    assert len(tb.graphs) >= 3


def test_map_strand_equals_numpy_backend(mates, pe_tables):
    """The strand step's cached graphs over several chunks: per-read
    candidate lists equal to the exact host path."""
    from walt_tpu.core.backends import NumpyBackend

    codes, lens = mates[0]
    g, ht = pe_tables[0][0]
    tb = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    got = tb.map_strand(codes, lens, g, ht, False, 5000, 6, PATTERN)
    want = NumpyBackend().map_strand(codes, lens, g, ht, False, 5000, 6,
                                     PATTERN)
    assert got == [list(w) for w in want]
    assert sum(map(len, got[:64])) and sum(map(len, got[64:128]))
    assert len(tb.graphs)


@pytest.mark.parametrize("mode", ["strand", "se", "pe"])
@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 1)])
def test_sharded_rows_replay_cached_parts(synth, dp, tp, mode):
    """The dp rows' parts replay from one cache, one lane per row, and the
    sharded steps equal walt_tpu's sharded programs on two chunks of one
    shape (the tables at walt_tpu's equal bucket-key ranges)."""
    if len(jax.devices()) < dp * tp:
        pytest.skip(f"needs {dp * tp} (virtual) JAX devices")
    jmesh = jsh.make_mesh(jax.devices()[:dp * tp], tp=tp)
    tmesh = tsh.make_mesh(["cpu"] * (dp * tp), tp=tp)
    dts, ct, ga = synth
    preads, lens = ga if mode == "pe" else ct
    convs = {"strand": ["CT00"], "se": ["CT00", "CT01"],
             "pe": ["GA10", "GA11"]}[mode]
    jt, tt, bits, ubits = _placed(dts, convs, jmesh, tmesh, "uniq",
                                  equal=True)
    kw = dict(pattern_name="3", ag_wildcard=mode == "pe", cand_slab=C)
    if mode == "pe":
        kw.update(search_bits=bits, uniq_bits=ubits,
                  verify_slab=tpe.VERIFY_SLAB, wl_factor=tpe.WL_FACTOR,
                  flat_factor=tpe.FLAT_FACTOR)
    else:
        kw.update(search_bits=bits[0] if mode == "strand" else bits,
                  uniq_bits=ubits[0] if mode == "strand" else ubits,
                  verify_slab=8, wl_factor=1.5)
    cache = StepCache()
    half = preads.shape[0] // 2
    got, want = [], []
    for a in (0, half):
        pr, ln = preads[a:a + half], lens[a:a + half]
        jin = (jnp.asarray(pr), jnp.asarray(ln), jnp.int32(5000),
               jnp.int32(6))
        tin = (_i32(pr), torch.from_numpy(ln), 5000, 6)
        if mode == "strand":
            j = jt[0]
            want.append(jsh.map_strand_sharded(
                *jin, j["key_base"], j["counter"], j["index"],
                j["key_words"], j["bucket_flagged"], j["pseq"],
                j["start_index"], mesh=jmesh, uniq_counter=j["uniq_counter"],
                uniq_words=j["uniq_words"], uniq_off=j["uniq_off"], **kw))
            got.append(tsh.map_strand_sharded(*tin, tt[0], mesh=tmesh,
                                              graphs=cache, **kw))
        elif mode == "se":
            want.append((jsh.map_single_end_sharded(
                *jin, tuple(jt), mesh=jmesh, **kw),))
            got.append((tsh.map_single_end_sharded(
                *tin, tt, mesh=tmesh, graphs=cache, **kw),))
        else:
            want.append(jsh.map_mate_sharded(*jin, tuple(jt), mesh=jmesh,
                                             **kw))
            got.append(tsh.map_mate_sharded(*tin, tt, mesh=tmesh,
                                            graphs=cache, **kw))
    assert {e.lane for e in cache._entries.values()} == set(range(dp))
    n_keys = len(cache)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            b = np.asarray(b)
            a = _np(a)
            if a.dtype == np.int32 and b.dtype == np.uint32:
                a = a.view(np.uint32)
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64))
    assert not all(np.array_equal(_np(a), _np(b))
                   for a, b in zip(got[0], got[1]))
    assert len(cache) == n_keys


def test_second_call_makes_no_tensor_from_host_data(monkeypatch, pe_tables,
                                                    both_strand_reads):
    """The strand pass's constant tables (and the plain verify stage's) are
    made once: a second SE and PE step with the same static arguments
    calls no ``torch.as_tensor``, ``torch.from_numpy`` or
    ``torch.tensor``."""
    codes, lens = both_strand_reads[False]
    inputs = (packing.from_np(_packed(codes)), torch.from_numpy(lens))
    _, tt, kw = _ct_step_args(pe_tables, False)

    def steps():
        tfold.map_single_end_device(*inputs, 5000, 6, tt, verify_slab=8,
                                    wl_factor=1.5, **kw)
        tpe.map_mate_device(*inputs, 5000, 6, tt, verify_slab=16,
                            wl_factor=3, flat_factor=12, **kw)

    steps()
    made = []
    for name in ("as_tensor", "from_numpy", "tensor"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k: (
            made.append(_n), _r(*a, **k))[1])
    steps()
    assert made == []
