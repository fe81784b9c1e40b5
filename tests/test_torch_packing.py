"""walt_tpu_torch.ops.packing == walt_tpu.ops.packing, bit for bit.

Random u32 words (with all-ones and all-zero words mixed in) go through the
JAX op and its torch counterpart; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walt_tpu.ops import packing as jp
from walt_tpu_torch.ops import packing as tp


def _words(rng, shape):
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    flat = w.reshape(-1)
    flat[:: 7] = 0xFFFFFFFF
    flat[3:: 11] = 0
    return w


def _t(a):
    """numpy uint32 -> int64 torch tensor of the zero-extended values."""
    return tp.u32(tp.from_np(a))


def _np(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("L", [23, 32, 100])
def test_clear_past_len_np_is_packing_zeroed_codes(L):
    """Lanes at or past each read's length become base code 0: the same
    words as walt_tpu's packer on codes zeroed past the length, whatever
    the batch padded them with (PAD_CODE 254 packs as G)."""
    rng = np.random.default_rng(L)
    lens = rng.integers(0, L + 1, 64)
    lens[:3] = [0, L, 16]
    codes = rng.integers(0, 4, (64, L), dtype=np.uint8)
    zeroed = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 254
    got = tp.clear_past_len_np(tp.pack_codes_np(codes), lens)
    np.testing.assert_array_equal(got, jp.pack_codes_np(zeroed))


def test_host_packers_identical():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (9, 77), dtype=np.uint8)
    np.testing.assert_array_equal(tp.pack_codes_np(codes),
                                  jp.pack_codes_np(codes))
    seq = rng.integers(0, 4, 1001, dtype=np.uint8)
    np.testing.assert_array_equal(tp.pack_genome_np(seq, 66),
                                  jp.pack_genome_np(seq, 66))


@pytest.mark.parametrize("op", ["convert_ct", "convert_ga"])
def test_conversions(op):
    w = _words(np.random.default_rng(2), (64, 7))
    want = np.asarray(getattr(jp, op)(jnp.asarray(w)))
    np.testing.assert_array_equal(_np(getattr(tp, op)(_t(w))), want)


def test_extract_lane():
    w = _words(np.random.default_rng(3), (40, 5))
    for pos in (0, 1, 15, 16, 17, 42, 79):
        want = np.asarray(jp.extract_lane(jnp.asarray(w), pos))
        np.testing.assert_array_equal(_np(tp.extract_lane(_t(w), pos)), want)


@pytest.mark.parametrize("W", [1, 7, 63])
def test_len_lane_masks(W):
    rng = np.random.default_rng(4 + W)
    lens = np.concatenate([
        np.asarray([0, 1, 15, 16, 17, W * 16, W * 16 + 5, -3], np.int32),
        rng.integers(0, W * 16 + 1, 50).astype(np.int32),
    ])
    want = np.asarray(jp.len_lane_masks(jnp.asarray(lens), W))
    got = tp.len_lane_masks(torch.from_numpy(lens), W)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("n_words", [1, 7, 13])
def test_window_words(n_words):
    rng = np.random.default_rng(5 + n_words)
    pseq = _words(rng, (300,))
    Wg = pseq.shape[0]
    # every in-word offset, starts near the end (the clamp applies), and
    # u32 positions far past the genome
    gpos = np.concatenate([
        np.arange(32, dtype=np.uint32) + 5 * 16,
        (Wg - 1) * 16 + np.arange(16, dtype=np.uint32),
        np.asarray([(Wg - n_words) * 16 + 9, 0, 0x80000003, 0xFFFFFFFF],
                   np.uint32),
        rng.integers(0, Wg * 16, 60).astype(np.uint32),
    ])
    want = np.asarray(jp.window_words(jnp.asarray(pseq), jnp.asarray(gpos),
                                      n_words))
    got = tp.window_words(tp.from_np(pseq), _t(gpos), n_words)
    np.testing.assert_array_equal(_np(got), want)


def test_popcount_and_carriers():
    w = _words(np.random.default_rng(6), (500,))
    want = np.asarray([bin(int(x)).count("1") for x in w])
    np.testing.assert_array_equal(tp.popcount32(_t(w)).numpy(), want)
    # int64 values <-> int32 bit carriers round-trip
    back = tp.to_i32(_t(w))
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy().view(np.uint32), w)
