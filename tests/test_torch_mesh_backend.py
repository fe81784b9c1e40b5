"""walt_tpu_torch's mesh backend against walt_tpu's and the exact host path.

``TorchBackend(mesh=make_mesh(["cpu"] * 8, tp=2))`` (dp=4 x tp=2) against
``JaxBackend(mesh=mesh8)`` on the 8-device virtual JAX CPU mesh, exactly,
fallback bits included: ``map_single_end``, ``map_strand_slabs`` and
``map_mate_slabs``.  SE and PE output through ``process_single_end`` and
``process_paired_end`` on the mesh backend is byte-identical to
``NumpyBackend`` (MR, SAM, ``.mapstats``).  On a mesh the device slab tiers
run even with the native library; ``entry.entry`` equals
``__graft_entry__.entry`` and ``entry.dryrun_multichip(8)`` passes on CPU
devices.
"""

import numpy as np
import pytest
import torch

from walt_tpu_torch import perf
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.index import io_walt
from walt_tpu_torch.core.torch_backend import TorchBackend
from walt_tpu_torch.parallel import sharded as tsh

PATTERN = get_pattern("3")


@pytest.fixture(scope="module")
def mesh8():
    import jax

    from walt_tpu.parallel import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    return make_mesh(jax.devices()[:8], tp=2)


@pytest.fixture(scope="module")
def tmesh():
    return tsh.make_mesh(["cpu"] * 8, tp=2)


@pytest.fixture(scope="module")
def tables(my_index):
    """{name: (genome, table)} of the four index tables."""
    gm, _ = io_walt.read_head(my_index)
    return {s: io_walt.read_table_cached(my_index + "_" + s, gm)
            for s in ("CT00", "CT01", "GA10", "GA11")}


def _load(fq):
    from walt_tpu_torch.host.fastq import FgetsLines, load_batch

    lines = FgetsLines(fq)
    try:
        return load_batch(lines, 10**6).packed()
    finally:
        lines.close()


def test_map_single_end_matches_jax_mesh(mesh8, tmesh, tables, se_fastq):
    from walt_tpu.core.jax_backend import JaxBackend

    codes, lens = _load(se_fastq)
    se = [tables["CT00"], tables["CT01"]]
    tb = TorchBackend(mesh=tmesh)
    reads0 = perf.counters().get("backend.reads", 0)
    got = tb.map_single_end(codes, lens, se, 5000, 6, PATTERN)
    reads = perf.counters().get("backend.reads", 0) - reads0
    want = JaxBackend(mesh=mesh8).map_single_end(codes, lens, se, 5000, 6,
                                                 PATTERN)
    for name, g, w in zip(("pos", "times", "minus", "mm", "fallback"), got,
                          want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert tb.rungs == {"CT00": "uniq", "CT01": "uniq"}
    assert reads == len(lens) and (~got[4]).mean() > 0.9


def test_map_strand_slabs_matches_jax_mesh(mesh8, tmesh, tables, se_fastq):
    from walt_tpu.core.jax_backend import JaxBackend

    codes, lens = _load(se_fastq)
    g, ht = tables["CT01"]
    got = TorchBackend(mesh=tmesh).map_strand_slabs(codes, lens, g, ht,
                                                    False, 5000, 6, PATTERN)
    want = JaxBackend(mesh=mesh8).map_strand_slabs(codes, lens, g, ht, False,
                                                   5000, 6, PATTERN)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)
    assert got[3].sum() > 0


@pytest.mark.parametrize("mate", [1, 2])
def test_map_mate_slabs_matches_jax_mesh(mesh8, tmesh, tables, pe_fastq,
                                         mate):
    from walt_tpu.core.jax_backend import JaxBackend

    codes, lens = _load(pe_fastq[mate - 1])
    tabs = ([tables["CT00"], tables["CT01"]] if mate == 1
            else [tables["GA10"], tables["GA11"]])
    # chunk ladder 32/64: several chunks of dp segments
    tb = TorchBackend(mesh=tmesh, chunk=64, small_chunk=32)
    streams, fb = tb.map_mate_slabs(codes, lens, tabs, mate == 2, 5000, 6,
                                    PATTERN)
    jstreams, jfb = JaxBackend(mesh=mesh8, chunk=64, small_chunk=32) \
        .map_mate_slabs(codes, lens, tabs, mate == 2, 5000, 6, PATTERN)
    np.testing.assert_array_equal(fb, jfb)
    for s, js in zip(streams, jstreams):
        for k in ("seed", "pos", "mm", "cnt"):
            np.testing.assert_array_equal(s[k], js[k], err_msg=k)
        assert all(s[k].flags.c_contiguous for k in s)
    assert (~fb).mean() > 0.9


def _bytes(out, suffixes):
    res = []
    for suf in suffixes:
        with open(out + suf, "rb") as f:
            res.append(f.read())
    return res


def _run_se(tmp_path, name, index, fastq, backend):
    from walt_tpu_torch.core.single_end import process_single_end

    out = str(tmp_path / name)
    for f in (out, out + ".mapstats"):
        open(f, "w").close()
    process_single_end(index, fastq, out, backend=backend, batch_size=64,
                       ambiguous=True, unmapped=True)
    return _bytes(out, ("", ".mapstats", "_ambiguous", "_unmapped"))


def _run_pe(tmp_path, name, index, pe_fastq, backend):
    from walt_tpu_torch.core.paired_end import process_paired_end

    out = str(tmp_path / name)
    for f in (out, out + ".mapstats"):
        open(f, "w").close()
    process_paired_end(index, pe_fastq[0], pe_fastq[1], out, batch_size=64,
                       sam=True, backend=backend)
    return _bytes(out, ("", ".mapstats"))


@pytest.mark.parametrize("native_lib", [True, False],
                         ids=["native", "no_native"])
def test_mesh_end_to_end_matches_numpy(tmp_path, monkeypatch, tmesh,
                                       my_index, se_fastq, pe_fastq,
                                       native_lib):
    """SE and PE through the drivers on the mesh backend: byte-identical to
    the exact host path, with the native library (PE: the mate step) and
    without it (PE: map_strand, whose slab merge runs on the mesh)."""
    from walt_tpu_torch import native
    from walt_tpu.core.backends import NumpyBackend

    se_want = _run_se(tmp_path, "se_np.mr", my_index, se_fastq,
                      NumpyBackend())
    pe_want = _run_pe(tmp_path, "pe_np.mr", my_index, pe_fastq,
                      NumpyBackend())
    if not native_lib:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    backend = TorchBackend(mesh=tmesh)
    reads0 = perf.counters().get("backend.reads", 0)
    assert _run_se(tmp_path, "se.mr", my_index, se_fastq, backend) == se_want
    assert _run_pe(tmp_path, "pe.mr", my_index, pe_fastq, backend) == pe_want
    assert perf.counters().get("backend.reads", 0) > reads0
    assert len(backend._tables) == 4


def _repeat_genome():
    """40 kbp: a 2 kbp unit repeated 15 times, then 10 kbp of random
    sequence, in one chromosome."""
    from walt_tpu_torch.genome import Genome

    rng = np.random.default_rng(41)
    seq = np.concatenate([np.tile(rng.integers(0, 4, 2000, dtype=np.uint8),
                                  15),
                          rng.integers(0, 4, 10_000, dtype=np.uint8)])
    return Genome(names=["chr1"], lengths=np.asarray([seq.size], np.uint32),
                  start_index=np.asarray([0, seq.size], np.uint32), seq=seq)


def test_mesh_runs_device_tiers_with_native(tmesh):
    """Reads in a 15-copy repeat overflow the tier-1 slab (8).  With the
    native library one device leaves them to the host replay, while a mesh
    re-runs them on the device tiers (slab 64 holds the 15 copies): its
    results equal the native exact replay on every read it resolved."""
    from walt_tpu_torch import native
    from walt_tpu.index.build import build_table
    from walt_tpu_torch.index.convert import (
        genome_from_arrays, table_from_arrays,
    )
    from walt_tpu_torch.synth import sample_reads

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    genome = _repeat_genome()
    # built by walt_tpu, handed to the port as arrays
    se = [(genome_from_arrays(g.names, g.lengths, g.start_index, g.seq,
                              g.strand),
           table_from_arrays(ht.counter, ht.index))
          for g, ht in (build_table(genome, c, PATTERN, verbose=False)
                        for c in ("CT00", "CT01"))]
    codes, lens, _ = sample_reads(genome, 512, 100, seed=43)
    single = TorchBackend(device="cpu").map_single_end(codes, lens, se, 5000,
                                                       6, PATTERN)
    slabs = []
    real = tsh.map_single_end_sharded

    def spy(*a, **kw):
        slabs.append(kw["verify_slab"])
        return real(*a, **kw)

    # one intra-op thread: the tier passes' large padded chunks (8192 reads
    # at slab 64) slow down ~10x when parallel test workers oversubscribe
    # the cores, and gain little from threads when run alone
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsh, "map_single_end_sharded", spy)
            mesh = TorchBackend(mesh=tmesh).map_single_end(
                codes, lens, se, 5000, 6, PATTERN)
    finally:
        torch.set_num_threads(threads)
    assert single[4].sum() > 256  # enough overflow to start the tiers
    assert 64 in slabs and mesh[4].sum() < single[4].sum() // 4
    ref = native.se_exact(codes, lens, se, False, 5000, 6, PATTERN)
    ok = ~mesh[4]
    for name, g, w in zip(("pos", "times", "minus", "mm"), mesh, ref):
        np.testing.assert_array_equal(g[ok], w[ok], err_msg=name)


def test_mesh_auto_and_make_mesh():
    assert TorchBackend(device="cpu", mesh="auto").mesh is None
    mesh = tsh.make_mesh(["cpu"] * 6)
    assert mesh.shape == {"dp": 3, "tp": 2}
    assert tsh.make_mesh(["cpu"] * 3).shape == {"dp": 3, "tp": 1}
    with pytest.raises(ValueError, match="tp=4"):
        tsh.make_mesh(["cpu"] * 6, tp=4)
    backend = TorchBackend(mesh=mesh, tp_accel="key16")
    assert backend.device == torch.device("cpu") and backend._dp == 3
    # chunk shapes tile dp
    chunks = list(backend._chunks(np.zeros((7, 40), np.uint8),
                                  np.full(7, 40, np.int32), PATTERN))
    assert [c[2].shape[0] % 3 for c in chunks] == [0]


def test_entry_matches_graft_entry():
    import jax

    import __graft_entry__ as g
    from walt_tpu_torch import entry

    jfn, jargs = g.entry()
    want = jax.jit(jfn)(*jargs)
    fn, args = entry.entry("cpu")
    got = fn(*args)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    assert int(got[3].sum()) > 0


def test_dryrun_multichip_cpu():
    from walt_tpu_torch import entry

    out = entry.dryrun_multichip(8, ["cpu"] * 8)
    assert (out["dp"], out["tp"]) == (4, 2)
    assert out["unique"] > 0.9 * out["reads"] and out["unique_pairs"] > 0


def test_entry_points_refuse_the_cpu_unasked(monkeypatch):
    """With no card, neither entry point falls back to the CPU unless the
    caller names it."""
    from walt_tpu_torch import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(4)
