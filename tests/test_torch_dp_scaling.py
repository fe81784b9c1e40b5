"""The mesh's dp rows on host threads, and tools/dp_scaling_torch.py.

- ``map_strand_sharded``, ``map_single_end_sharded`` and
  ``map_mate_sharded`` on dp-only port meshes (``["cpu"] * 4`` and
  ``["cpu"] * 8``, tp = 1, each dp row on a thread of the mesh's pool)
  equal walt_tpu's programs on ``make_mesh(jax.devices()[:n], tp=1)``, bit
  for bit, fallback bits included;
- at dp = 2 and 4 the dp program equals ``map_single_end_device`` over the
  serial chunks of B/dp reads, element for element;
- a row that raises ``torch.cuda.OutOfMemoryError`` surfaces that type in
  the caller after every other row has finished, and the next call
  succeeds;
- ``Mesh.run_rows`` runs a dp = 1 row on the calling thread and makes no
  pool, and with several rows runs them all at once on the pool;
- the launch counter helper of ``ops/verify`` counts exactly under 8
  threads;
- the tool's ``--device cpu`` rehearsal prints every key of a report row,
  with no measured number, and writes no file; ``--device cuda`` without
  a card exits non-zero.
"""

import importlib.util
import json
import os
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sharded import C, PATTERN, _i32, _np, _placed, _reads
from walt_tpu.parallel import sharded as jsh
from walt_tpu_torch.ops import se_fold as tfold
from walt_tpu_torch.ops import verify
from walt_tpu_torch.parallel import sharded as tsh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 256  # reads per chunk: a multiple of dp = 8


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 120 kbp genome, the port's four tables of it (also written as a
    WALT index), their host-prepared device tables (3 key words), packed
    reads for the C->T and G->A tables, and 100 bp bisulfite reads."""
    from walt_tpu_torch.index.build import CONVERSIONS, build_table
    from walt_tpu_torch.index.io_walt import write_index
    from walt_tpu_torch.ops.device_index import build_device_table
    from walt_tpu_torch.synth import make_genome, sample_reads

    genome = make_genome(120_000, seed=3)
    tables = {c: build_table(genome, c, PATTERN, verbose=False)
              for c in CONVERSIONS}
    index = str(tmp_path_factory.mktemp("dp") / "toy.dbindex")
    write_index(index, genome, tables)
    dts = {c: build_device_table(*tables[c], PATTERN, with_key_words=True)
           for c in CONVERSIONS}
    codes, lens, _ = sample_reads(genome, B, 100, seed=9)
    return dict(genome=genome, se_tables=[tables["CT00"], tables["CT01"]],
                index=index, dts=dts, ct=_reads(genome, B, 5),
                ga=_reads(genome, B, 7, ag=True), codes=codes, lens=lens)


def _meshes(n):
    import jax

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} (virtual) JAX devices")
    return (jsh.make_mesh(jax.devices()[:n], tp=1),
            tsh.make_mesh(["cpu"] * n, tp=1))


@pytest.mark.parametrize("dp", [4, 8])
def test_map_strand_sharded_dp_only_matches_jax(data, dp):
    jmesh, tmesh = _meshes(dp)
    dts, (preads, lens) = data["dts"], data["ct"]
    (jt,), (tt,), (bits,), (ubits,) = _placed(dts, ["CT00"], jmesh, tmesh,
                                              "uniq")
    kw = dict(pattern_name="3", ag_wildcard=False, search_bits=bits,
              verify_slab=8, cand_slab=C, wl_factor=1.5, uniq_bits=ubits)
    want = jsh.map_strand_sharded(
        jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000), jnp.int32(6),
        jt["key_base"], jt["counter"], jt["index"], jt["key_words"],
        jt["bucket_flagged"], jt["pseq"], jt["start_index"], mesh=jmesh,
        uniq_counter=jt["uniq_counter"], uniq_words=jt["uniq_words"],
        uniq_off=jt["uniq_off"], **kw)
    got = tsh.map_strand_sharded(_i32(preads), torch.from_numpy(lens), 5000,
                                 6, tt, mesh=tmesh, **kw)
    for j, t in zip(want, got):
        np.testing.assert_array_equal(_np(t).astype(np.int64),
                                      _np(j).astype(np.int64))
    assert _np(got[3]).sum() > 0
    assert tmesh._pool is not None  # the rows ran on the mesh's threads


@pytest.mark.parametrize("dp", [4, 8])
def test_map_single_end_sharded_dp_only_matches_jax(data, dp):
    jmesh, tmesh = _meshes(dp)
    dts, (preads, lens) = data["dts"], data["ct"]
    jt, tt, bits, ubits = _placed(dts, ["CT00", "CT01"], jmesh, tmesh,
                                  "uniq")
    kw = dict(pattern_name="3", ag_wildcard=False, search_bits=bits,
              verify_slab=8, cand_slab=C, wl_factor=1.5, uniq_bits=ubits)
    want = jsh.map_single_end_sharded(
        jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000),
        jnp.int32(6), tuple(jt), mesh=jmesh, **kw)
    got = tsh.map_single_end_sharded(
        _i32(preads), torch.from_numpy(lens), 5000, 6, tt, mesh=tmesh, **kw)
    np.testing.assert_array_equal(_np(got), _np(want).astype(np.int64))


@pytest.mark.parametrize("dp", [4, 8])
def test_map_mate_sharded_dp_only_matches_jax(data, dp):
    from walt_tpu_torch.ops import pe_map as tpe

    jmesh, tmesh = _meshes(dp)
    dts, (preads, lens) = data["dts"], data["ga"]
    jt, tt, bits, ubits = _placed(dts, ["GA10", "GA11"], jmesh, tmesh,
                                  "uniq")
    kw = dict(pattern_name="3", ag_wildcard=True, search_bits=bits,
              verify_slab=tpe.VERIFY_SLAB, cand_slab=C,
              wl_factor=tpe.WL_FACTOR, flat_factor=tpe.FLAT_FACTOR,
              uniq_bits=ubits)
    jmeta, jflat = jsh.map_mate_sharded(
        jnp.asarray(preads), jnp.asarray(lens), jnp.int32(5000),
        jnp.int32(6), tuple(jt), mesh=jmesh, **kw)
    tmeta, tflat = tsh.map_mate_sharded(
        _i32(preads), torch.from_numpy(lens), 5000, 6, tt, mesh=tmesh, **kw)
    jmeta = np.asarray(jmeta)
    # F1 steered around: no dp segment's stream spills its capacity
    counts = (jmeta & 0xFF).astype(np.int64) + ((jmeta >> 8) & 0xFF)
    assert counts.reshape(1, dp, -1).sum(-1).max() <= \
        tpe.FLAT_FACTOR * B // dp
    assert counts.sum() > 0
    np.testing.assert_array_equal(tmeta.numpy().view(np.uint32), jmeta)
    np.testing.assert_array_equal(tflat.numpy().view(np.uint32),
                                  np.asarray(jflat))


def _se_program(backend, tables, codes, lens, chunk):
    """The SE tier-1 step of ``backend`` over ``codes`` in chunks of
    ``chunk`` reads: each chunk's (chunk, 3) result."""
    tabs, bits, ubits = [], [], []
    for g, ht in tables:
        dt, dev = backend._device_table(g, ht, PATTERN, 1)
        tabs.append(dev)
        bits.append(dt.max_bucket_bits)
        ubits.append(dt.uniq_bits)
    kw = dict(pattern_name="3", ag_wildcard=False, search_bits=tuple(bits),
              uniq_bits=tuple(ubits), verify_slab=8, cand_slab=C,
              wl_factor=1.5)
    step = (tfold.map_single_end_device if backend.mesh is None else
            lambda *a, **k: tsh.map_single_end_sharded(*a, mesh=backend.mesh,
                                                       **k))
    return [step(pc, pl, 5000, 6, tuple(tabs), **kw)
            for _, _, pc, pl in backend._chunks(codes, lens, PATTERN, chunk)]


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_program_equals_serial_chunks(data, dp):
    from walt_tpu_torch.core.torch_backend import TorchBackend

    tables, codes, lens = data["se_tables"], data["codes"], data["lens"]
    n = codes.shape[0]
    mesh_b = TorchBackend(mesh=tsh.make_mesh(["cpu"] * dp, tp=1))
    single = TorchBackend(device="cpu")
    (got,) = _se_program(mesh_b, tables, codes, lens, n)
    want = torch.cat(_se_program(single, tables, codes, lens, n // dp))
    assert got.shape == want.shape == (n, 3)
    assert torch.equal(got, want)
    pos, times, _, _, fb = tfold.unpack_se_result(got.numpy())
    assert (times[~fb] > 0).mean() > 0.5  # most reads mapped on the rows


def test_row_error_reaches_caller_after_every_row(monkeypatch, data):
    """Row 1 raises a CUDA out-of-memory error: the caller gets that type
    once rows 0, 2 and 3 have finished, and the mesh maps again."""
    from walt_tpu_torch.core.torch_backend import TorchBackend

    tables, codes, lens = data["se_tables"], data["codes"], data["lens"]
    n = codes.shape[0]
    mesh = tsh.make_mesh(["cpu"] * 4, tp=1)
    backend = TorchBackend(mesh=mesh)
    (want,) = _se_program(backend, tables, codes, lens, n)
    real = tsh._map_shard
    done, lock = set(), threading.Lock()

    def failing(reads, *a, **k):
        # a row's reads are a view of the chunk: its offset names the row
        row = reads[0].storage_offset() // reads[0].numel()
        if row == 1:
            raise torch.cuda.OutOfMemoryError("row 1 out of memory")
        time.sleep(0.2)  # the other rows outlast the failing one
        out = real(reads, *a, **k)
        with lock:
            done.add(row)
        return out

    monkeypatch.setattr(tsh, "_map_shard", failing)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="row 1"):
        _se_program(backend, tables, codes, lens, n)
    assert done == {0, 2, 3}
    assert mesh._pool._work_queue.empty()
    monkeypatch.setattr(tsh, "_map_shard", real)
    (again,) = _se_program(backend, tables, codes, lens, n)
    assert torch.equal(again, want)


@pytest.mark.parametrize("dp", [1, 3])
def test_run_rows_threads_only_with_several_rows(dp):
    """dp = 1 runs its row on the calling thread and makes no pool; dp > 1
    runs each row on one of the mesh's dp threads, results in row order."""
    mesh = tsh.make_mesh(["cpu"] * dp, tp=1)
    barrier = threading.Barrier(dp, timeout=60)

    def row(d):
        barrier.wait()  # every row is running at once
        return d, threading.current_thread()

    got = mesh.run_rows(row)
    assert [d for d, _ in got] == list(range(dp))
    threads = {t for _, t in got}
    if dp == 1:
        assert threads == {threading.current_thread()}
        assert mesh._pool is None
    else:
        assert len(threads) == dp
        assert threading.current_thread() not in threads


def test_launch_counter_is_exact_under_threads():
    before = verify.stage_launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            verify.count_launch("stage_launches") for _ in range(10_000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert verify.stage_launches - before == 80_000
    finally:
        sys.setswitchinterval(interval)
        verify.stage_launches = before


def _tool():
    spec = importlib.util.spec_from_file_location(
        "dp_scaling_torch", os.path.join(ROOT, "tools", "dp_scaling_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DP_KEYS = {"devices", "virtual", "reads_per_s", "end_to_end_vs_1dev",
           "device_program_reads_per_s", "serial_chunks_reads_per_s",
           "implied_dp_efficiency", "speedup_vs_1dev", "dp_efficiency",
           "fallback", "launches", "serial_launches", "peak_gib_per_card",
           "results_equal"}
TP_KEYS = {"tp", "virtual", "device_program_s", "implied_tp_efficiency",
           "legacy_slab_merge_s", "legacy_slab_merge_share"}


def test_tool_cpu_rehearsal_prints_every_key_and_writes_nothing(
        data, tmp_path, capsys):
    index, tool = data["index"], _tool()
    # the index's genome is the genome it was built from
    np.testing.assert_array_equal(tool.index_genome(index).seq,
                                  data["genome"].seq)
    out = tmp_path / "scaling.json"
    repo_report = os.path.join(ROOT, "SCALING_TORCH.json")
    existed = os.path.exists(repo_report)
    assert tool.main([index, "--device", "cpu", "--out", str(out)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    rows, report = lines[:-1], lines[-1]
    assert report["results"] == rows and report["cards"] == 0
    dp_rows = [r for r in rows if "devices" in r]
    assert [r["devices"] for r in dp_rows] == list(tool.MESH_SIZES)
    assert [r["virtual"] for r in dp_rows] == [False, True, True, True]
    for r in dp_rows:
        assert set(r) == DP_KEYS
        assert r["results_equal"] is True
        assert r["launches"] == r["serial_launches"]
    tp_rows = [r for r in rows if "tp" in r]
    assert [r["tp"] for r in tp_rows] == [1, 2]
    assert set(tp_rows[1]) == TP_KEYS and set(tp_rows[0]) <= TP_KEYS
    for r in rows:
        assert all(r[k] is None for k in tool.MEASURED if k in r)
    assert not out.exists()
    assert os.path.exists(repo_report) == existed


def test_tool_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _tool().main(["--out", str(tmp_path / "x.json")])
    assert e.value.code != 0
    assert not (tmp_path / "x.json").exists()
