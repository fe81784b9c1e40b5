"""The spans and counters of a tp mesh and of set-up, on virtual CPU
meshes.

On a mesh the PE decode counts, per tp shard t, the flat entries decoded
from shard t's stream (``mesh.flat_rows.<t>``) and the mates whose
fallback bit shard t set (``mesh.fallback_reads.<t>``), and the mates that
fall back only because their shards' merged entries overflow the slab
(``mesh.merged_overflow_reads``); with tp > 1 the seed-order merge of the
shard streams is the span ``backend.decode.merge``.  One device counts none
of them.  Set-up leaves ``setup.read_table`` (each table a mapping run
reads), ``setup.table_prep`` (each table's host prep) and ``setup.place``
(each placement: per shard and card on a mesh).
"""

from __future__ import annotations

import numpy as np
import pytest

from walt_tpu_torch import perf
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.core.torch_backend import TorchBackend
from walt_tpu_torch.index import io_walt
from walt_tpu_torch.parallel import sharded

PATTERN = get_pattern("3")
#: (cards, tp) of the virtual meshes: tp = 4 on one row, and on two rows
MESHES = [(4, 4), (8, 4)]


@pytest.fixture
def fresh_perf():
    perf.reset()
    yield perf
    perf.reset()


@pytest.fixture(scope="module")
def pe_tables(my_index):
    gm, _ = io_walt.read_head(my_index)
    return [[io_walt.read_table_cached(my_index + "_" + s, gm)
             for s in pair] for pair in (("CT00", "CT01"), ("GA10", "GA11"))]


def _load(fq):
    from walt_tpu_torch.host.fastq import FgetsLines, load_batch

    lines = FgetsLines(fq)
    try:
        return load_batch(lines, 10**6).packed()
    finally:
        lines.close()


def _mesh_backend(cards, tp, **kw):
    return TorchBackend(mesh=sharded.make_mesh(["cpu"] * cards, tp=tp),
                        chunk=64, small_chunk=32, **kw)


def _keep_decoded(backend):
    """Wrap ``backend._decode_mate``: the (spans, host, n) it decoded and
    the fallback mask it returned, per call."""
    got = []
    real = backend._decode_mate

    def decode(spans, host, n):
        streams, fb = real(spans, host, n)
        got.append((spans, host, n, fb))
        return streams, fb

    backend._decode_mate = decode
    return got


def _recount(spans, host, n, dp, C):
    """From the host arrays alone: entries per shard, each shard's
    fallback bits, and the merged entry counts per strand."""
    T = host[0].shape[0]
    rows = np.zeros(T, dtype=np.int64)
    bits = np.zeros((T, n), dtype=bool)
    acc = np.zeros((2, n), dtype=np.int64)
    for i, (a, z) in enumerate(spans):
        metas = host[2 * i].astype(np.int64)
        seg = metas.shape[1] // dp
        for t in range(T):
            for g in range(dp):
                a0 = a + g * seg
                z0 = min(a0 + seg, z)
                if a0 >= z:
                    break
                meta = metas[t, g * seg:g * seg + z0 - a0]
                rows[t] += int(((meta & 0xFF) + ((meta >> 8) & 0xFF)).sum())
                bits[t, a0:z0] = (meta >> 16) & 1
                acc[0, a0:z0] += meta & 0xFF
                acc[1, a0:z0] += (meta >> 8) & 0xFF
    return rows, bits, (acc > C).any(0)


def _mesh_counters():
    return {k: v for k, v in perf.counters().items()
            if k.startswith("mesh.")}


@pytest.mark.parametrize("cards,tp", MESHES)
def test_merge_span_on_each_mesh_finish_call(fresh_perf, pe_tables,
                                             pe_fastq, cards, tp):
    """One ``backend.decode.merge`` record, a child of ``backend.decode``,
    per finish call on a tp mesh, each inside its parent."""
    backend = _mesh_backend(cards, tp)
    calls = 0
    for mate in (0, 1):
        codes, lens = _load(pe_fastq[mate])
        for half in (slice(0, 70), slice(70, None)):
            backend.map_mate_slabs(codes[half], lens[half], pe_tables[mate],
                                   mate == 1, 5000, 6, PATTERN)
            calls += 1
    recs = perf.spans()
    merges = [r for r in recs if r[0] == "backend.decode.merge"]
    decodes = [r for r in recs if r[0] == "backend.decode"]
    assert len(merges) == len(decodes) == calls
    for m in merges:
        assert m[6] == "backend.decode"
        assert any(d[2] == m[2] and d[3] <= m[3] and m[4] <= d[4]
                   for d in decodes)
    assert perf._counts["backend.decode.merge"] == calls


@pytest.mark.parametrize("cards,tp", MESHES)
@pytest.mark.parametrize("cand_slab", [32, 2])
def test_shard_counters_equal_a_recount(fresh_perf, pe_tables, pe_fastq,
                                        cards, tp, cand_slab):
    """``mesh.flat_rows.<t>`` sum to the entries decoded, each shard's
    ``mesh.fallback_reads.<t>`` and ``mesh.merged_overflow_reads`` equal a
    recount from the decoded host arrays, and the shards' bits and the
    merged overflow together are every fallback the finish calls return.
    A slab of 2 makes merged overflows that no shard flags."""
    backend = _mesh_backend(cards, tp, cand_slab=cand_slab)
    seen = _keep_decoded(backend)
    for mate in (0, 1):
        codes, lens = _load(pe_fastq[mate])
        backend.map_mate_slabs(codes, lens, pe_tables[mate], mate == 1, 5000,
                               6, PATTERN)
    rows = np.zeros(tp, dtype=np.int64)
    shard_fb = np.zeros(tp, dtype=np.int64)
    merged = returned = 0
    for spans, host, n, fb in seen:
        r, bits, over = _recount(spans, host, n, cards // tp, cand_slab)
        rows += r
        shard_fb += bits.sum(1)
        only = over & ~bits.any(0)
        merged += int(only.sum())
        np.testing.assert_array_equal(bits.any(0) | only, fb)
        assert int(bits.any(0).sum()) + int(only.sum()) == int(fb.sum())
        returned += int(fb.sum())
    got = _mesh_counters()
    assert set(got) == ({f"mesh.flat_rows.{t}" for t in range(tp)}
                        | {f"mesh.fallback_reads.{t}" for t in range(tp)}
                        | {"mesh.merged_overflow_reads"})
    assert [got[f"mesh.flat_rows.{t}"] for t in range(tp)] == rows.tolist()
    assert sum(rows) > 0 and sum(got[f"mesh.flat_rows.{t}"]
                                 for t in range(tp)) == sum(rows)
    assert [got[f"mesh.fallback_reads.{t}"]
            for t in range(tp)] == shard_fb.tolist()
    assert got["mesh.merged_overflow_reads"] == merged
    assert perf.counters()["backend.fallback_reads"] == returned
    if cand_slab == 2:
        assert merged > 0


def test_one_card_counts_no_mesh(fresh_perf, pe_tables, pe_fastq):
    backend = TorchBackend(device="cpu", chunk=64, small_chunk=32,
                           cand_slab=2)
    for mate in (0, 1):
        codes, lens = _load(pe_fastq[mate])
        _, fb = backend.map_mate_slabs(codes, lens, pe_tables[mate],
                                       mate == 1, 5000, 6, PATTERN)
        assert fb.any()
    assert _mesh_counters() == {}
    assert not [r for r in perf.spans() if r[0] == "backend.decode.merge"]
    assert perf.counters()["backend.reads"] > 0


def _run_pe(path, my_index, pe_fastq, backend):
    from walt_tpu_torch.core.paired_end import process_paired_end

    open(path, "w").close()
    open(path + ".mapstats", "w").close()
    process_paired_end(my_index, pe_fastq[0], pe_fastq[1], path,
                       batch_size=64, backend=backend)
    out = []
    for suf in ("", ".mapstats"):
        with open(path + suf, "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("cards,tp", [(1, 1)] + MESHES)
def test_setup_spans_and_placed_bytes(fresh_perf, tmp_path, my_index,
                                      pe_fastq, cards, tp):
    """A PE mapping run reads four tables, preps each once and places each
    once per shard and card, and every card of the run holds table bytes.
    A second run in the same process places nothing and holds the same
    bytes.  Set-up keeps no counter: ``table_bytes(card)`` is the bytes
    placed on a card."""
    import threading

    backend = (TorchBackend(device="cpu", chunk=64, small_chunk=32)
               if cards == 1 else _mesh_backend(cards, tp))
    _run_pe(str(tmp_path / "a.mr"), my_index, pe_fastq, backend)
    recs = perf.spans()
    names = [r[0] for r in recs]
    main = threading.get_ident()
    reads = [r for r in recs if r[0] == "setup.read_table"]
    assert len(reads) == 4 and all(r[2] == main and r[1] is None
                                   for r in reads)
    assert names.count("setup.table_prep") == 4
    # a shard's placement per card it is on: tp cards, whatever the rows
    assert names.count("setup.place") == 4 * tp
    for r in recs:
        if r[0] in ("setup.table_prep", "setup.place"):
            assert r[2] != main and r[1] == 0  # the first batch's mapper
    cards_used = ({d for row in backend.mesh.devices for d in row}
                  if backend.mesh is not None else {backend.device})
    placed = {d: backend.table_bytes(d) for d in cards_used}
    assert all(v > 0 for v in placed.values())
    assert sum(placed.values()) == backend.table_bytes()
    assert not [k for k in perf.counters() if k.startswith("setup.")]
    perf.reset()
    _run_pe(str(tmp_path / "b.mr"), my_index, pe_fastq, backend)
    names = [r[0] for r in perf.spans()]
    assert names.count("setup.read_table") == 4
    assert "setup.table_prep" not in names and "setup.place" not in names
    assert {d: backend.table_bytes(d) for d in cards_used} == placed


@pytest.mark.parametrize("cards,tp", [(1, 1), (4, 4)])
def test_output_unchanged_by_tracing(tmp_path, monkeypatch, my_index,
                                     pe_fastq, cards, tp):
    """MR and ``.mapstats`` are the same bytes with the operator's trace
    and report on (``WALTX_PROFILE_DIR``, ``WALTX_PERF``) and off."""

    def backend():
        return (TorchBackend(device="cpu", chunk=64, small_chunk=32)
                if cards == 1 else _mesh_backend(cards, tp))

    plain = _run_pe(str(tmp_path / "off.mr"), my_index, pe_fastq, backend())
    monkeypatch.setenv("WALTX_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setenv("WALTX_PERF", "1")
    traced = _run_pe(str(tmp_path / "on.mr"), my_index, pe_fastq, backend())
    assert (tmp_path / "prof").is_dir()
    assert traced == plain and plain[0]
