"""walt_tpu_torch's single-end fold == the NumPy spec and walt_tpu's fold.

Adversarial random slabs as in tests/test_se_fold_summaries.py: heavy
position collisions (the ``times`` dedup quirk), empty segments and all-seed
mixes; every output is compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walt_tpu_torch.constants import get_pattern
from walt_tpu.host.replay_vec import replay_single_batch
from walt_tpu.ops import se_fold as jfold
from walt_tpu_torch.ops import se_fold as tfold


def _random_slab(rng, B, C, n_seeds):
    seed = rng.integers(-1, n_seeds, (B, C)).astype(np.int8)
    # tiny position alphabet: forces the adjacent-dedup / anchor quirks
    pos = rng.integers(0, 5, (B, C)).astype(np.uint32)
    pos[rng.random((B, C)) < 0.05] = 0xFFFFFFF0  # u32 positions past 2^31
    mm = rng.integers(0, 7, (B, C)).astype(np.int32)
    return seed, pos, mm


def _torch_slab(seed, pos, mm):
    return (torch.from_numpy(seed), torch.from_numpy(pos.astype(np.int64)),
            torch.from_numpy(mm))


@pytest.mark.parametrize("trial,max_mm", [(0, 6), (1, 6), (2, 6), (3, 2),
                                          (4, 0)])
def test_fold_matches_spec_and_jax(trial, max_mm):
    pattern = get_pattern("3")
    rng = np.random.default_rng(100 + trial)
    B, C = 64, 16
    slabs = [_random_slab(rng, B, C, pattern.pattern_len) for _ in range(2)]

    got = tfold.se_fold([_torch_slab(*s) for s in slabs], max_mm, pattern)
    got = [g.numpy() for g in got]
    want = replay_single_batch(slabs, max_mm, pattern)
    jax_got = jfold.se_fold(
        [tuple(map(jnp.asarray, s)) for s in slabs], max_mm, pattern)
    for g, w, j in zip(got, want, jax_got):
        np.testing.assert_array_equal(g.astype(np.int64),
                                      np.asarray(w).astype(np.int64))
        np.testing.assert_array_equal(g.astype(np.int64),
                                      np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("C", [1, 8, 32])
def test_segment_summaries_match_jax(C):
    pattern = get_pattern("3")
    rng = np.random.default_rng(7 + C)
    slab = _random_slab(rng, 48, C, pattern.pattern_len)
    got = tfold.segment_summaries(*_torch_slab(*slab), pattern)
    want = jfold.segment_summaries(*map(jnp.asarray, slab), pattern)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(
            got[k].numpy().astype(np.int64),
            np.asarray(want[k]).astype(np.int64), err_msg=k)


def test_unpack_round_trip():
    rng = np.random.default_rng(3)
    B = 40
    pos = rng.integers(0, 1 << 32, B, dtype=np.int64)
    times = rng.integers(0, 1000, B)
    mm = rng.integers(0, 7, B)
    minus = rng.integers(0, 2, B)
    fb = rng.integers(0, 2, B)
    packed = np.stack([pos, times, (mm << 2) | (minus << 1) | fb], axis=1)
    p, t, mi, m, f = tfold.unpack_se_result(packed)
    np.testing.assert_array_equal(p, pos.astype(np.uint32))
    np.testing.assert_array_equal(t, times)
    np.testing.assert_array_equal(mi, minus.astype(bool))
    np.testing.assert_array_equal(m, mm)
    np.testing.assert_array_equal(f, fb.astype(bool))
    assert p.dtype == np.uint32 and t.dtype == np.int32 and m.dtype == np.int32
