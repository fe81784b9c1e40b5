"""walt_tpu_torch.hbm_plan against walt_tpu.hbm_plan, and the H100 plans.

At the JAX package's 16 GiB and 4.25 GiB reserve the port's plan with
every table split evenly over the cards equals walt_tpu's field by field
(the entry limit never binds there); the port sizes each width by its
heaviest card, never below the even split.  At an H100's 79.1 GiB the
entry limit decides tp, and no plan ever holds a shard of 2^31 entries or
more.  The plan bounds the heaviest shard: from the genome size alone by
a model of walt_tpu's equal bucket-key ranges, from the tables' counters by
the runtime's own split into ranges of about equal entry counts.  A table
of human base composition shows that the model bounds the runtime's split,
that the counters give the runtime's own shares and placed bytes, and that
the runtime accepts the width either plan picks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from walt_tpu import hbm_plan as jplan
from walt_tpu_torch import hbm_plan
from walt_tpu_torch.core.torch_backend import TorchBackend
from walt_tpu_torch.ops import pipeline
from walt_tpu_torch.ops.pipeline import ENTRY_LIMIT
from walt_tpu_torch.parallel import sharded

G = 1 << 30
JAX_HBM, JAX_RESERVE = 16 << 30, 4352 << 20
H100_HBM = int(79.1 * G)
HG19 = 3_100_000_000
SHIFTED = 2_243_483_648  # chip_smoke phase 13's genome

# every case of tests/test_hbm_plan.py: (genome bp, tables, kwargs)
JAX_CASES = [(512_000_000, 2, {}), (768_000_000, 2, {}),
             (1_000_000_000, 2, {}), (HG19, 2, {}), (HG19, 4, {}),
             (512_000_000, 2, dict(b_small=True))]
GRID = [100_000_000, 250_000_000, 500_000_000, 1_000_000_000,
        2_000_000_000, SHIFTED, HG19, 4_000_000_000]


def _even(tp, n_tables, counters=None):
    """walt_tpu's split: every table's entries evenly over the cards."""
    return np.full((n_tables, tp), 1 / tp)


def _same(monkeypatch, bp, nt, **kw):
    want = jplan.plan_tables(bp, nt, **kw)
    with monkeypatch.context() as m:
        m.setattr(hbm_plan, "card_shares", _even)
        m.setattr(hbm_plan, "bucket_shares", _even)
        got = hbm_plan.plan_tables(bp, nt, hbm_bytes=JAX_HBM,
                                   reserve=JAX_RESERVE, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert hbm_plan.heaviest_shard(bp, got.tp) < ENTRY_LIMIT
    # the heaviest card carries at least the even split's bytes: the same
    # layout with more bytes per card, or a wider one
    try:
        heavy = hbm_plan.plan_tables(bp, nt, hbm_bytes=JAX_HBM,
                                     reserve=JAX_RESERVE, **kw)
    except ValueError:  # no width's heaviest card fits, key16 at 64 either
        assert hbm_plan.card_bytes(
            bp, nt, 64, False, kw.get("uniq_ratio", 1.0),
            kw.get("b_small", False)) > JAX_HBM - JAX_RESERVE
        return got
    assert heavy.fits() and heavy.tp >= got.tp
    assert (heavy.per_table_base, heavy.genome_bp) == (got.per_table_base,
                                                       got.genome_bp)
    if (heavy.tp, heavy.uniq) == (got.tp, got.uniq):
        assert heavy.per_chip_bytes >= got.per_chip_bytes
        assert heavy.per_chip_bytes > got.per_chip_bytes or got.tp == 1
    return got


@pytest.mark.parametrize("bp,nt,kw", JAX_CASES)
def test_equals_walt_tpu_on_its_cases(monkeypatch, bp, nt, kw):
    _same(monkeypatch, bp, nt, uniq_ratio=0.93, **kw)


@pytest.mark.parametrize("nt", [2, 4])
@pytest.mark.parametrize("bp", GRID)
def test_equals_walt_tpu_on_the_grid(monkeypatch, bp, nt):
    for ratio in (1.0, 0.93):
        for b_small in (False, True):
            _same(monkeypatch, bp, nt, uniq_ratio=ratio, b_small=b_small)


def test_table_bytes_equal_walt_tpu():
    for bp in GRID:
        for ratio in (1.0, 0.93):
            assert hbm_plan.table_bytes(bp, ratio) == jplan.table_bytes(
                bp, ratio)
    assert hbm_plan.NB1 == jplan.NB1


@pytest.mark.parametrize("bp,nt,tp,gib", [(HG19, 2, 4, 35.28),
                                          (HG19, 4, 4, 57.01),
                                          (SHIFTED, 2, 2, 35.44)])
def test_h100_plans(bp, nt, tp, gib):
    """On 79.1 GiB one card would hold the tables in memory, but not their
    entries in int32 indices, and hg19's heavier tp=2 shard (~0.71 of 3.1e9
    entries) is past 2^31 too: hg19 at tp=4, the 2.24 Gbp genome at tp=2,
    uniq.  The heaviest card's bytes: hg19 SE's T-range card holds ~0.51
    of both C->T tables (the even split's 18.03 GiB would be a quarter);
    PE's T-range card also ~0.305 of both G->A tables (36.06 even); the
    2.24 Gbp genome's {G, T} card ~0.715 of each (25.09 even).  Each
    table's per-bucket arrays (0.14 GiB) count at the share of its
    heaviest range under the runtime's split (0.52 at tp=4, 0.76 at tp=2),
    where the even split's quarter or half were walt_tpu's."""
    p = hbm_plan.plan_tables(bp, nt, hbm_bytes=H100_HBM,
                             reserve=JAX_RESERVE, uniq_ratio=0.93)
    assert (p.tp, p.uniq) == (tp, True) and p.fits()
    assert abs(p.per_chip_bytes / G - gib) < 0.05
    assert hbm_plan.heaviest_shard(bp, tp) < ENTRY_LIMIT
    assert hbm_plan.heaviest_shard(bp, tp // 2) >= ENTRY_LIMIT
    # the backend's measured reserve picks the same layout
    q = hbm_plan.plan_tables(bp, nt, hbm_bytes=H100_HBM, uniq_ratio=0.93)
    assert (q.tp, q.uniq, q.reserve) == (tp, True, TorchBackend.HBM_RESERVE)
    # memory alone (the JAX package's plan) would keep one card
    j = jplan.plan_tables(bp, nt, hbm_bytes=H100_HBM, reserve=JAX_RESERVE,
                          uniq_ratio=0.93)
    assert j.tp == 1 and bp >= ENTRY_LIMIT


@pytest.mark.parametrize("hbm_gib", [8, 16, 24, 40, 79.1, 80, 141, 512])
def test_no_plan_reaches_the_entry_limit(hbm_gib):
    for bp in GRID:
        for nt in (1, 2, 4):
            for b_small in (False, True):
                try:
                    p = hbm_plan.plan_tables(
                        bp, nt, hbm_bytes=int(hbm_gib * G),
                        reserve=JAX_RESERVE, b_small=b_small)
                except ValueError:
                    continue  # does not fit 64 shards
                assert hbm_plan.heaviest_shard(bp, p.tp) < ENTRY_LIMIT
                assert -(-bp // p.tp) < ENTRY_LIMIT
                assert p.fits()


@pytest.fixture(scope="module")
def human_tables():
    """(genome bases, the four tables (converted genome, table), SE's two
    first) of a 1 Mbp random genome with hg19's base composition (A = T =
    0.295, C = G = 0.205)."""
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.synth import make_genome

    g = make_genome(1_000_000, n_chroms=2, seed=3)
    rng = np.random.default_rng(3)
    g = dataclasses.replace(g, seq=rng.choice(
        4, g.seq.shape[0], p=[0.295, 0.205, 0.205, 0.295]).astype(np.uint8))
    return int(g.seq.shape[0]), [
        build_table(g, conv, get_pattern("3"), verbose=False, sort_threads=1)
        for conv in ("CT00", "CT01", "GA10", "GA11")]


@pytest.fixture(scope="module")
def human_like(human_tables):
    """(genome bases, the two SE tables' counters) of :func:`human_tables`."""
    n, tables = human_tables
    return n, [ht.counter for _, ht in tables[:2]]


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_model_bounds_the_runtime_split(human_like, tp):
    """The size-only share bounds the heaviest of the runtime's tp shards
    of a human-composition table, and the share measured on the counters
    is the runtime's own split."""
    n, counters = human_like
    measured = hbm_plan.heaviest_shard(n, tp, counters)
    for c in counters:
        _, bounds = sharded.balanced_bounds(c, tp)
        assert measured >= int(np.diff(bounds).max())
    assert measured <= hbm_plan.heaviest_shard(n, tp)
    if tp == 2:  # the model's heavier half (equal key ranges) holds ~0.705
        # of the entries, the runtime's about half
        entries = int(counters[0][-1])
        assert hbm_plan.heaviest_shard(n, tp) > 0.69 * entries
        assert measured < 0.51 * entries


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_card_shares_bound_the_runtime_split(human_like, tp):
    """The heaviest card's modelled share of the SE tables bounds the
    heaviest card's share of the runtime's split, which is what the
    counters give: each card within 1% of 1/tp of every table."""
    n, counters = human_like
    measured = hbm_plan.card_shares(tp, 2, counters)
    model = hbm_plan.card_shares(tp, 2)
    assert measured.shape == model.shape == (2, tp)
    assert measured.sum(0).max() <= model.sum(0).max()
    for c, row in zip(counters, measured):
        _, bounds = sharded.balanced_bounds(c, tp)
        assert np.allclose(row * int(c[-1]), np.diff(bounds))
    assert np.abs(measured - 1 / tp).max() < 0.01
    # each table's buckets: the runtime's ranges cover them, each card's
    # share bounded by the size-only plan's whole table
    buckets = hbm_plan.bucket_shares(tp, 2, counters)
    assert np.allclose(buckets.sum(axis=1), 1)
    assert (buckets > 0).all()
    assert (buckets <= hbm_plan.bucket_shares(tp, 2)).all()
    # the model's equal key ranges: a C->T table has no C, so the C-range
    # card of tp=4 holds almost nothing and the T-range card about half
    if tp == 4:
        assert (model[:, 1] < 0.02).all()
        assert 0.45 < model[:, 3].min() <= model[:, 3].max() < 0.52


@pytest.mark.parametrize("tp,nt", [(2, 2), (4, 2), (2, 4), (4, 4)],
                         ids=["2", "4", "2-pe", "4-pe"])
def test_card_bytes_bound_the_placed_shards(human_tables, tp, nt):
    """The heaviest card's modelled bytes are the bytes shard_and_place puts
    on it: within a few hundred bytes with the counters and the run count
    of the placed shards, and bounded by the size-only model; for SE's two
    tables and PE's four (whose entries the tp=4 cards hold about evenly,
    where walt_tpu's equal key ranges put ~0.3 of one conversion's tables
    and ~0.5 of the other's on the A-range and T-range cards).  The
    per-bucket arrays follow the runtime's bucket ranges, which are uneven
    (a range of few entries spans many buckets): at this size (1 Mbp of
    entries against 4^12 buckets) they outweigh the entries."""
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.ops import device_index
    from walt_tpu_torch.parallel import make_mesh

    n, tables = human_tables
    tables = tables[:nt]
    pattern = get_pattern("3")
    mesh = make_mesh([torch.device("cpu")] * tp, tp=tp)
    per_card, runs = np.zeros(tp, np.int64), 0
    card_entries = np.zeros(tp, np.int64)
    for g, ht in tables:
        dt = device_index.build_device_table(g, ht, pattern)
        grid, _ = sharded.shard_and_place(dt, mesh, pattern, accel="uniq")
        for t, sh in enumerate(grid[0]):
            per_card[t] += sum(v.untyped_storage().nbytes()
                               for v in sh.values() if torch.is_tensor(v))
            runs += sh["uniq_words"].shape[0]
            card_entries[t] += sh["index"].shape[0]
    counters = [ht.counter for _, ht in tables]
    model = hbm_plan.card_bytes(n, nt, tp, True, runs / (nt * n),
                                counters=counters)
    assert per_card.max() <= model < per_card.max() + 4096
    assert model <= hbm_plan.card_bytes(n, nt, tp, True, 1.0)
    if (tp, nt) == (4, 4):
        # the cards carry the tables' entries about evenly
        assert card_entries.max() < 1.01 * card_entries.mean()


@pytest.mark.parametrize("use_counters", [False, True])
def test_runtime_accepts_the_planned_tp(human_like, monkeypatch,
                                        use_counters):
    """With the entry limit at 0.6 of the table, an even split would fit
    tp=2.  The size-only plan models walt_tpu's equal key ranges (the
    heavier tp=2 shard holds ~0.705) and picks tp=4; the plan from the
    counters reads the runtime's own split (about half each) and picks
    tp=2, and the runtime refuses anything narrower.  The runtime accepts
    either plan."""
    n, counters = human_like
    entries = int(counters[0][-1])
    monkeypatch.setattr(pipeline, "ENTRY_LIMIT", int(0.6 * entries))
    assert -(-entries // 2) < pipeline.ENTRY_LIMIT  # the even-split count
    p = hbm_plan.plan_tables(n, 2, hbm_bytes=512 * G, reserve=JAX_RESERVE,
                             counters=counters if use_counters else None)
    assert (p.tp, p.uniq) == (2 if use_counters else 4, True)
    for c in counters:
        sharded._shard_bounds(c, p.tp, "planned")
        if use_counters:
            with pytest.raises(ValueError, match="int32 entry indices"):
                sharded._shard_bounds(c, p.tp // 2, "narrower")


def test_defaults_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass hbm_bytes"):
        hbm_plan.plan_tables(HG19, 2)
    p = hbm_plan.plan_tables(HG19, 2, hbm_bytes=H100_HBM)
    assert p.reserve == TorchBackend.HBM_RESERVE


def test_main_prints_the_deployments(capsys):
    assert hbm_plan.main(["--hbm-gib", "79.1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    assert ["tp=4, uniq run index" in line for line in out] == [True, True,
                                                                False]
    assert "tp=2, uniq run index" in out[2]
