"""The tp split of a table: bucket ranges of about equal entry counts.

``sharded.balanced_bounds`` cuts a table's CSR counter into T bucket
ranges: strictly increasing cuts, every shard at least one bucket, each
shard within one bucket of N/T entries.  On a virtual tp = 4 CPU mesh, PE
through ``TorchBackend(mesh=...)`` on a genome of human base composition
(a converted table then holds no C, so walt_tpu's equal bucket-key ranges
put about half of a C->T table on the T range) keeps every shard's own
fallbacks near the one-card backend's, where walt_tpu's equal ranges
(``bucket_range_bounds`` standing in for the split) spill the heavy
shards' route capacity; the output bytes equal the exact host path's and
the one-card backend's under both splits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from walt_tpu_torch import perf
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.parallel import sharded

PATTERN = get_pattern("3")


def _counter(counts) -> np.ndarray:
    """A CSR counter (uint32, nb + 1) over per-bucket ``counts``."""
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.uint32)


def _skewed():
    """A C->T-like table over 4^8 buckets: the top key bits are the first
    base, and a converted strand holds A 0.295, C 0, G 0.205, T 0.5."""
    rng = np.random.default_rng(1)
    share = np.repeat([0.295, 0.0, 0.205, 0.5], 4**7)
    return _counter(rng.poisson(share * 8.0))


def _big_bucket():
    """4096 buckets of about one entry, and one of 10,000: larger than
    N/T for every T above 1."""
    counts = np.random.default_rng(2).poisson(1.0, 4096)
    counts[1000] = 10_000
    return _counter(counts)


COUNTERS = {
    "skewed": _skewed,
    "big_bucket": _big_bucket,
    "empty": lambda: _counter(np.zeros(4096, np.int64)),
    "eight_buckets": lambda: _counter(
        np.random.default_rng(3).integers(0, 50, 8)),
}


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(COUNTERS))
def test_balanced_bounds(name, tp):
    c = COUNTERS[name]()
    nb, n = c.shape[0] - 1, int(c[-1])
    kb, eb = sharded.balanced_bounds(c, tp)
    assert kb.shape == eb.shape == (tp + 1,)
    assert kb[0] == 0 and kb[-1] == nb  # every bucket is covered
    assert (np.diff(kb) >= 1).all()  # strictly increasing, none empty
    np.testing.assert_array_equal(eb, c[kb].astype(np.int64))
    biggest = int(np.diff(c.astype(np.int64)).max())
    assert int(np.diff(eb).max()) <= math.ceil(n / tp) + biggest
    # the runtime's split, and the given bounds checked
    got = sharded._shard_bounds(c, tp, "test")
    np.testing.assert_array_equal(got[0], kb)
    np.testing.assert_array_equal(got[1], eb)
    if name == "skewed" and tp == 4:
        # walt_tpu's equal ranges: half the entries on the T range, none on
        # the C range; the balanced split holds each within 1% of N/4
        equal = np.diff(sharded.bucket_range_bounds(c, tp)[1]) / n
        assert equal[1] == 0 and equal[3] > 0.49
        assert np.abs(np.diff(eb) / n - 0.25).max() < 0.01


def test_balanced_bounds_refuse_more_shards_than_buckets():
    with pytest.raises(ValueError, match="do not split"):
        sharded.balanced_bounds(_counter(np.ones(4, np.int64)), 8)
    kb, _ = sharded.balanced_bounds(_counter(np.ones(4, np.int64)), 4)
    assert kb.tolist() == [0, 1, 2, 3, 4]


# ---- the mechanism on a virtual tp = 4 mesh --------------------------------

#: pairs per batch and chunk: large enough that a routed shard's capacity K
#: is set by its 1.25*B*S/T term (3,840 of 12,288 pairs), not by the +128
N_PAIRS = 4096
#: how far a shard's own fallback share may pass the one-card backend's
SLACK = 0.01


@pytest.fixture(scope="module")
def human_pe(tmp_path_factory):
    """(index prefix, FASTQ pair) of a 1 Mbp random genome of hg19's base
    composition and N_PAIRS 2x100 bp bisulfite pairs."""
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.index.io_walt import write_index
    from walt_tpu_torch.synth import codes_to_fastq, make_genome, sample_pairs

    d = tmp_path_factory.mktemp("tp_split")
    g = make_genome(1_000_000, n_chroms=2, seed=3)
    rng = np.random.default_rng(3)
    g = dataclasses.replace(g, seq=rng.choice(
        4, g.seq.shape[0], p=[0.295, 0.205, 0.205, 0.295]).astype(np.uint8))
    index = str(d / "human.dbindex")
    write_index(index, g, {
        conv: build_table(g, conv, PATTERN, verbose=False, sort_threads=1)
        for conv in ("CT00", "CT01", "GA10", "GA11")})
    c1, l1, c2, l2 = sample_pairs(g, N_PAIRS, 100, seed=5)
    fq = (str(d / "r_1.fq"), str(d / "r_2.fq"))
    codes_to_fastq(c1, l1, fq[0])
    codes_to_fastq(c2, l2, fq[1])
    return index, fq


def _run_pe(path, human_pe, backend):
    """Output bytes (MR, .mapstats) and the perf counters of one PE run."""
    from walt_tpu_torch.core.paired_end import process_paired_end

    index, fq = human_pe
    for f in (path, path + ".mapstats"):
        open(f, "w").close()
    perf.reset()
    process_paired_end(index, fq[0], fq[1], path, batch_size=N_PAIRS,
                       backend=backend)
    counts = perf.counters()
    perf.reset()
    out = []
    for suf in ("", ".mapstats"):
        with open(path + suf, "rb") as f:
            out.append(f.read())
    return out, counts


def _max_shard_share(counts, tp) -> float:
    return max(counts[f"mesh.fallback_reads.{t}"]
               for t in range(tp)) / counts["backend.reads"]


def test_balanced_split_keeps_the_shards_on_the_device(tmp_path, human_pe,
                                                       monkeypatch):
    from walt_tpu_torch.core.backends import NumpyBackend
    from walt_tpu_torch.core.torch_backend import TorchBackend

    want, _ = _run_pe(str(tmp_path / "np.mr"), human_pe, NumpyBackend())
    one, c1 = _run_pe(str(tmp_path / "one.mr"), human_pe,
                      TorchBackend(device="cpu", chunk=N_PAIRS))
    one_share = c1["backend.fallback_reads"] / c1["backend.reads"]

    def mesh_backend():
        return TorchBackend(mesh=sharded.make_mesh(["cpu"] * 4, tp=4),
                            chunk=N_PAIRS)

    got, cm = _run_pe(str(tmp_path / "mesh.mr"), human_pe, mesh_backend())
    assert got == want == one
    assert cm["backend.reads"] == 2 * N_PAIRS
    assert _max_shard_share(cm, 4) <= one_share + SLACK

    # walt_tpu's equal bucket-key ranges, below the backend: the heavy
    # shards spill their route capacity, past the slack
    monkeypatch.setattr(sharded, "balanced_bounds",
                        sharded.bucket_range_bounds)
    got_eq, ce = _run_pe(str(tmp_path / "mesh_eq.mr"), human_pe,
                         mesh_backend())
    assert got_eq == want
    assert _max_shard_share(ce, 4) > one_share + SLACK
    assert ce["backend.fallback_reads"] > cm["backend.fallback_reads"]
