"""The port's device shapes against walt_tpu's knobs, and its memory ladder
under ``WALTX_HBM_GB``.

- walt_tpu's ``JaxBackend`` reads its shapes (``chunk``, ``_wl1``,
  ``pe_verify_slab``, ``pe_wl``, ``pe_flat_factor``) from ``WALTX_CHUNK``,
  ``WALTX_WL1``, ``WALTX_PE_SLAB``, ``WALTX_PE_WL`` and ``WALTX_PE_FLAT``;
  ``TorchBackend(device="cpu")`` reads none of them: its shapes are its
  arguments and the constants of ``ops/pipeline`` and ``ops/pe_map``, after
  construction and after ``reset_adaptive()``, which resets only the
  adaptive state (``_seed0_rate``, ``_wl1``).  Both read ``WALTX_HBM_GB``
  alike.
- With walt_tpu's shapes set through its environment and the port's on the
  instance: at SE ``verify_slab_t1`` 16 / wl1 1.25 and 12 / 2.0 (chunk 512)
  ``map_single_end`` equals walt_tpu's where neither side fell back, with
  equal fallback bits; at the PE shapes (8, 2, 8), (12, 2.5, 10), the
  defaults (16, 3, 12) and (24, 3, 12) at ``-b 12`` (``exact_b`` on at
  slab 24 only) ``map_mate_slabs`` equals walt_tpu's; the drivers' MR and
  ``.mapstats`` on a backend with these shapes are byte-identical to
  ``walt_tpu.cli --backend numpy``.
- Three of ``tests/test_oom.py``'s ladder tests, ported: a table without
  its uniq index, the key16 rung chosen by a ``WALTX_HBM_GB`` budget, and a
  budget nothing fits (``HbmBudgetError``, then the exact host path).

Variables are set only through ``monkeypatch``: walt_tpu's ``WALTX_CHUNK``
wins over an explicit argument, so a variable left behind would change
later tests.
"""

import os

import numpy as np
import pytest

from walt_tpu_torch import perf
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.core.torch_backend import TorchBackend
from walt_tpu_torch.host.fastq import FgetsLines, load_batch
from walt_tpu_torch.index import io_walt
from walt_tpu_torch.ops import device_index as tdi
from walt_tpu_torch.ops import pe_map as tpe
from walt_tpu_torch.ops import pipeline as tpipe

PATTERN = get_pattern("3")
#: walt_tpu's shape variables, in the order of :func:`_shapes`
SHAPE_KNOBS = ("WALTX_CHUNK", "WALTX_WL1", "WALTX_PE_SLAB", "WALTX_PE_WL",
               "WALTX_PE_FLAT")
KNOBS = SHAPE_KNOBS + ("WALTX_HBM_GB", "WALTX_KEY_RUNG")
#: the shapes of :func:`_shapes` on both sides with no variable set
DEFAULTS = (131072, 1.5, 16, 3, 12)


@pytest.fixture
def clean_env(monkeypatch):
    """No knob set, whatever the calling environment holds."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _shapes(b):
    return (b.chunk, b._wl1, b.pe_verify_slab, b.pe_wl, b.pe_flat_factor)


@pytest.mark.parametrize("env", [
    {}, {"WALTX_CHUNK": "512"}, {"WALTX_WL1": "1.25"},
    {"WALTX_PE_SLAB": "8"}, {"WALTX_PE_WL": "2"}, {"WALTX_PE_FLAT": "8"},
    {"WALTX_HBM_GB": "0.5"},
    {"WALTX_PE_SLAB": "24", "WALTX_PE_WL": "2.5", "WALTX_PE_FLAT": "10",
     "WALTX_WL1": "2", "WALTX_HBM_GB": "79.1"},
], ids=lambda e: ",".join(f"{k[6:]}={v}" for k, v in e.items()) or "unset")
def test_knobs_match_walt_tpu(clean_env, env):
    from walt_tpu.core.jax_backend import JaxBackend

    for k, v in env.items():
        clean_env.setenv(k, v)
    jb, tb = JaxBackend(), TorchBackend(device="cpu")
    # walt_tpu follows each shape variable; the port stays at its constants
    assert _shapes(jb) == tuple(float(env[k]) if k in env else d
                                for k, d in zip(SHAPE_KNOBS, DEFAULTS))
    assert _shapes(tb) == DEFAULTS
    assert tb._hbm_budget() == jb._hbm_budget()
    assert tb.verify_slab_t1 == jb.verify_slab_t1 == 8
    assert tb._hbm_budget() == (None if "WALTX_HBM_GB" not in env else
                                int(float(env["WALTX_HBM_GB"]) * (1 << 30)))
    # walt_tpu's environment wins over an explicit chunk; the port takes
    # the argument
    assert JaxBackend(chunk=256).chunk == int(env.get("WALTX_CHUNK", 256))
    assert TorchBackend(device="cpu", chunk=256).chunk == 256
    # reset_adaptive (the CLI calls it per file): walt_tpu reads its shape
    # variables again, the port's shapes stay as they are
    for k in KNOBS:
        clean_env.delenv(k, raising=False)
    clean_env.setenv("WALTX_WL1", "2.5")
    clean_env.setenv("WALTX_PE_SLAB", "12")
    jb.reset_adaptive()
    tb.reset_adaptive()
    assert (jb._wl1, jb.pe_verify_slab, jb.pe_wl) == (2.5, 12, 3)
    assert _shapes(tb) == DEFAULTS


def test_reset_adaptive_resets_only_the_adaptive_state(clean_env):
    """``reset_adaptive`` restores the seed-0 rate and a widened tier-1
    worklist, and leaves the chunk and the PE mate step's shapes alone."""
    tb = TorchBackend(device="cpu", chunk=512)
    tb._seed0_rate = 0.3
    tb._wl1 = tpipe.WL_FACTOR  # as a dense-candidate batch widens it
    tb.pe_verify_slab, tb.pe_wl, tb.pe_flat_factor = 8, 2, 8
    tb.reset_adaptive()
    assert tb._seed0_rate is None and tb._wl1 == tpipe.WL1
    assert _shapes(tb) == (512, tpipe.WL1, 8, 2, 8)


@pytest.fixture(scope="module")
def rep(tmp_path_factory):
    """A 200 kbp genome with repeat families (so the slab and worklist
    shapes decide which reads fall back), its index, 600 reads, 300 pairs
    and its tables: dict(index, se, pe, tables=[[CT00, CT01], [GA10,
    GA11]])."""
    from walt_tpu_torch.index.build import build_all_tables
    from walt_tpu_torch.index.io_walt import write_index
    from walt_tpu_torch.synth import (codes_to_fastq, make_genome_repetitive,
                                      sample_pairs, sample_reads,
                                      write_genome_fasta)

    d = tmp_path_factory.mktemp("knobs")
    genome = make_genome_repetitive(200_000, n_chroms=2, seed=5)
    write_genome_fasta(genome, str(d / "genome.fa"))
    index = str(d / "rep.dbindex")
    write_index(index, *build_all_tables([str(d / "genome.fa")],
                                         verbose=False))
    codes, lens, _ = sample_reads(genome, 600, 100, seed=44)
    codes_to_fastq(codes, lens, str(d / "se.fq"))
    c1, l1, c2, l2 = sample_pairs(genome, 300, 100, seed=45, frag_lo=150,
                                  frag_hi=500)
    pe = (str(d / "pe_1.fq"), str(d / "pe_2.fq"))
    codes_to_fastq(c1, l1, pe[0])
    codes_to_fastq(c2, l2, pe[1])
    gm, _ = io_walt.read_head(index)
    tables = [[io_walt.read_table_cached(index + s, gm) for s in pair]
              for pair in (("_CT00", "_CT01"), ("_GA10", "_GA11"))]
    return dict(index=index, se=str(d / "se.fq"), pe=pe, tables=tables,
                genome=genome)


def _load(fastq):
    lines = FgetsLines(fastq)
    try:
        return load_batch(lines, 10**6).packed()
    finally:
        lines.close()


@pytest.mark.parametrize("slab,wl1", [(16, 1.25), (12, 2.0)],
                         ids=lambda v: str(v))
def test_map_single_end_matches_walt_tpu_under_knobs(clean_env, rep, slab,
                                                     wl1):
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu_torch.synth import sample_reads

    clean_env.setenv("WALTX_WL1", str(wl1))
    clean_env.setenv("WALTX_CHUNK", "512")
    tables = rep["tables"][0]
    codes, lens, _ = sample_reads(rep["genome"], 1500, 100, seed=43)
    tb = TorchBackend(device="cpu", chunk=512, small_chunk=64,
                      verify_slab_t1=slab)
    tb._wl1 = wl1
    jb = JaxBackend(small_chunk=64, verify_slab_t1=slab)
    assert tb.chunk == jb.chunk == 512 and tb._wl1 == jb._wl1 == wl1
    c0 = perf.counters()
    got = tb.map_single_end(codes, lens, tables, 5000, 6, PATTERN)
    c1 = perf.counters()
    want = jb.map_single_end(codes, lens, tables, 5000, 6, PATTERN)
    np.testing.assert_array_equal(got[4], want[4])
    ok = ~got[4]
    assert ok.mean() > 0.9
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g[ok], np.asarray(w)[ok])
    assert tb._wl1 == jb._wl1
    assert tuple(c1.get(k, 0) - c0.get(k, 0) for k in (
        "backend.reads", "backend.fallback_reads")) == (jb.total_reads,
                                                        jb.fallback_reads)
    # the slab reached the device passes: slab 8 keeps fewer reads
    default = TorchBackend(device="cpu", small_chunk=64)
    fb8 = default.map_single_end(codes, lens, tables, 5000, 6, PATTERN)[4]
    assert fb8.sum() > got[4].sum()


@pytest.mark.parametrize("shape", [(8, 2, 8), (24, 3, 12), (12, 2.5, 10),
                                   (16, 3, 12)],
                         ids=lambda s: "/".join(map(str, s)))
@pytest.mark.parametrize("mate", [1, 2])
def test_map_mate_slabs_matches_walt_tpu_under_knobs(clean_env, rep, shape,
                                                      mate):
    from walt_tpu.core.jax_backend import JaxBackend

    for k, v in zip(("WALTX_PE_SLAB", "WALTX_PE_WL", "WALTX_PE_FLAT"),
                    shape):
        clean_env.setenv(k, str(v))
    seen = []
    real = tpe.map_mate_device
    clean_env.setattr(tpe, "map_mate_device", lambda *a, **kw: (
        seen.append((kw["verify_slab"], kw["wl_factor"], kw["flat_factor"],
                     kw["exact_b"])) or real(*a, **kw)))
    codes, lens = _load(rep["pe"][mate - 1])
    args = (codes, lens, rep["tables"][mate - 1], mate == 2, 12, 6, PATTERN)
    tb = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    assert _shapes(tb)[2:] == DEFAULTS[2:]
    tb.pe_verify_slab, tb.pe_wl, tb.pe_flat_factor = shape
    streams, fb = tb.map_mate_slabs(*args)
    jstreams, jfb = JaxBackend(chunk=64, small_chunk=32).map_mate_slabs(*args)
    # every chunk's step took the shapes, and -b 12 takes the exact_b path
    # at slab 24 only
    assert seen and set(seen) == {(*shape, 12 < shape[0])}
    np.testing.assert_array_equal(fb, jfb)
    for s, j in zip(streams, jstreams):
        for k in ("seed", "pos", "mm", "cnt"):
            np.testing.assert_array_equal(s[k], j[k], err_msg=k)
    assert (~fb).mean() > 0.5


def _read_all(out):
    with open(out, "rb") as a, open(out + ".mapstats", "rb") as b:
        return a.read(), b.read()


@pytest.mark.parametrize("case", [
    ("se", dict(chunk=512), dict(_wl1=1.25), []),
    ("se", dict(chunk=512), dict(_wl1=1.25), ["-b", "12"]),
    ("pe", dict(chunk=512), dict(pe_verify_slab=8, pe_wl=2,
                                 pe_flat_factor=8), ["-b", "12"]),
    ("pe", {}, dict(pe_verify_slab=24, pe_wl=3, pe_flat_factor=12),
     ["-b", "12"]),
], ids=["se", "se-b12", "pe-8/2/8-b12", "pe-24/3/12-b12"])
def test_cli_under_knobs_matches_numpy(clean_env, tmp_path, rep, case):
    """The drivers the CLI runs, in process on a backend with the shapes
    set (the CLI's ``reset_adaptive`` would restore ``_wl1``), against
    ``walt_tpu.cli --backend numpy`` with the same flags."""
    from walt_tpu.cli import main_map
    from walt_tpu_torch.core.paired_end import process_paired_end
    from walt_tpu_torch.core.single_end import process_single_end

    mode, kw, shapes, flags = case
    reads = (["-r", rep["se"]] if mode == "se"
             else ["-1", rep["pe"][0], "-2", rep["pe"][1]])
    ref, out = str(tmp_path / "numpy.mr"), str(tmp_path / "torch.mr")
    main_map(["-i", rep["index"], *reads, "-o", ref, "--backend", "numpy",
              *flags])
    backend = TorchBackend(device="cpu", **kw)
    for name, value in shapes.items():
        setattr(backend, name, value)
    b = int(flags[1]) if flags else 5000
    for f in (out, out + ".mapstats"):
        open(f, "w").close()
    if mode == "se":
        process_single_end(rep["index"], rep["se"], out, b=b,
                           backend=backend)
    else:
        process_paired_end(rep["index"], *rep["pe"], out, b=b,
                           backend=backend)
    assert _read_all(out) == _read_all(ref)


# ---- the memory ladder (ported from tests/test_oom.py) --------------------

def _run_se(index, fastq, out, backend):
    from walt_tpu_torch.core.single_end import process_single_end

    open(out, "w").close()
    open(out + ".mapstats", "w").close()
    process_single_end(index, fastq, out, batch_size=64, max_mismatches=6,
                       backend=backend)
    return _read_all(out)


def _jax_se(tmp_path, my_index, se_fastq):
    """walt_tpu's JaxBackend on the same reads (test_oom.py's ``ok``)."""
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.core.single_end import process_single_end

    ok = str(tmp_path / "ok.mr")
    open(ok, "w").close()
    open(ok + ".mapstats", "w").close()
    process_single_end(my_index, se_fastq, ok, batch_size=64,
                       max_mismatches=6,
                       backend=JaxBackend(chunk=256, small_chunk=64))
    return _read_all(ok)


def _no_uniq(monkeypatch):
    real = tdi.build_uniq_device
    monkeypatch.setattr(tdi, "build_uniq_device",
                        lambda *a, **kw: real(*a, **dict(kw, max_bytes=8)))


def test_no_uniq_degrade_identical(clean_env, tmp_path, my_index, se_fastq):
    """A table built without the uniq run index maps identically; with the
    native library the ladder takes key16 first, without it u32 word 0."""
    import torch

    from walt_tpu_torch import native

    _no_uniq(clean_env)
    backend = TorchBackend(device="cpu", chunk=256, small_chunk=64)
    got = _run_se(my_index, se_fastq, str(tmp_path / "nouniq.mr"), backend)
    assert backend._tables
    assert all(e[0].uniq_bits == 0 for e in backend._tables.values())
    kws = [e[1]["key_words"] for e in backend._tables.values()]
    if native.get_lib() is not None:
        assert all(k.dtype == torch.int16 and k.dim() == 1 for k in kws)
        assert set(backend.rungs.values()) == {"key16"}
    else:
        assert all(k.dtype == torch.int32 and k.dim() == 2 for k in kws)
        assert set(backend.rungs.values()) == {"u32 word0"}
    assert got == _jax_se(tmp_path, my_index, se_fastq)


def test_key16_rung_identical(clean_env, tmp_path, my_index, se_fastq):
    """A WALTX_HBM_GB budget fitting 2n (key16) but not 4n (u32 word 0) of
    key bytes per table takes the key16 rung and maps byte-identically."""
    import torch

    gm, _ = io_walt.read_head(my_index)
    g0, ht = io_walt.read_table(my_index + "_CT00", gm)
    n = int(ht.index.shape[0])
    dt = tdi.build_device_table(g0, ht, PATTERN)
    base = (dt.pseq.nbytes + dt.counter.nbytes + dt.index.nbytes
            + dt.start_index.nbytes + dt.bucket_flagged.nbytes)
    backend = TorchBackend(device="cpu", chunk=256, small_chunk=64)
    # process_single_end sets table_budget_hint = 2: table 1 gets (budget -
    # reserve) / 2 = base + 2.5n, table 2 the rest (~base + 3n): both fit
    # 2n, neither 4n
    budget = 2 * base + 5 * n + backend.HBM_RESERVE
    clean_env.setenv("WALTX_HBM_GB", repr(budget / 2**30))
    _no_uniq(clean_env)
    got = _run_se(my_index, se_fastq, str(tmp_path / "k16.mr"), backend)
    kws = [e[1]["key_words"] for e in backend._tables.values()]
    assert len(kws) == 2 and all(k.dtype == torch.int16 for k in kws)
    assert backend.rungs == {"CT00": "key16", "CT01": "key16"}
    assert got == _jax_se(tmp_path, my_index, se_fastq)


def test_hbm_budget_error_degrades_to_host(clean_env, tmp_path, my_index,
                                           se_fastq):
    """A table that cannot fit at all: HbmBudgetError, then the exact host
    path with identical output."""
    from walt_tpu.core.backends import get_backend
    from walt_tpu_torch.core.errors import HbmBudgetError

    clean_env.setenv("WALTX_HBM_GB", "0.0001")  # ~100 KB: nothing fits
    backend = TorchBackend(device="cpu", chunk=256, small_chunk=64)
    gm, _ = io_walt.read_head(my_index)
    g, ht = io_walt.read_table(my_index + "_CT00", gm)
    with pytest.raises(HbmBudgetError):
        backend._device_table(g, ht, PATTERN)

    ok = str(tmp_path / "ok.mr")
    open(ok, "w").close()
    open(ok + ".mapstats", "w").close()
    from walt_tpu.core.single_end import process_single_end

    process_single_end(my_index, se_fastq, ok, batch_size=64,
                       max_mismatches=6, backend=get_backend("numpy"))
    deg = TorchBackend(device="cpu", chunk=256, small_chunk=64)
    reads0 = perf.counters().get("backend.reads", 0)
    assert _run_se(my_index, se_fastq, str(tmp_path / "deg.mr"),
                   deg) == _read_all(ok)
    assert not deg._tables
    assert perf.counters().get("backend.reads", 0) == reads0


def test_chip_smoke_knobs_phase_rehearses_on_cpu(clean_env, tmp_path,
                                                 my_index, se_fastq, pe_fastq):
    """chip_smoke.py's phase 15 on the CPU: its budgets put the SE tables
    on key16 and the PE tables on u32 word 0 by the backend's own ladder,
    the outputs equal the exact host path, and the environment is restored.
    The CPU launches no kernel, so the launch counts are stood in for."""
    import shutil

    import torch

    import chip_smoke as cs
    from walt_tpu_torch.core.paired_end import process_paired_end
    from walt_tpu_torch.core.single_end import process_single_end

    work = tmp_path / "smoke"
    work.mkdir()
    index = str(work / "my.dbindex")
    for f in os.listdir(os.path.dirname(my_index)):
        if f.startswith("my.dbindex"):
            shutil.copy(os.path.join(os.path.dirname(my_index), f), work)
    ref, ref_pe = str(work / "mesh_exact.mr"), str(work / "mesh_exact_pe.mr")
    cs.fresh(ref, ref_pe)
    process_single_end(index, se_fastq, ref, backend=cs.AllFallback())
    process_paired_end(index, *pe_fastq, ref_pe, backend=cs.AllFallbackPE())
    clean_env.setattr(cs, "counts", lambda: {"verify_worklist": 1,
                                             "verify_windows": 0})
    before = dict(os.environ)
    cs.knobs_phase(index, se_fastq, pe_fastq, torch.device("cpu"))
    assert dict(os.environ) == before
    for mode in ("se", "pe"):
        assert os.path.getsize(work / f"knobs_{mode}.mr") > 0
