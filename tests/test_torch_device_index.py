"""walt_tpu_torch.ops.device_index against walt_tpu's table builders.

On the ``my_index`` fixture tables: the copied host prep equals the JAX
package's, ``place_table`` keeps every bit, and the torch builders of the
uniq run index, key16 prefixes and packed key words equal the host oracle
(``build_uniq_host`` / ``pack_key_words``) and the walt_tpu device builders.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.core.refmap import padded_seq
from walt_tpu_torch.index import io_walt
from walt_tpu.ops import device_index as jdi
from walt_tpu_torch.ops import device_index as tdi


@pytest.fixture(scope="module", params=["_CT00", "_GA11"])
def prepared(request, my_index):
    gm, _ = io_walt.read_head(my_index)
    g, ht = io_walt.read_table(my_index + request.param, gm)
    pattern = get_pattern("3")
    dt = tdi.build_device_table(g, ht, pattern)
    return g, ht, pattern, dt, tdi.place_table(dt, "cpu")


def _u32(t):
    return t.numpy().view(np.uint32)


def test_host_prep_and_place_table(prepared):
    g, ht, pattern, dt, dev = prepared
    want = jdi.build_device_table(g, ht, pattern)
    for f in ("pseq", "counter", "index", "start_index", "bucket_flagged"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(want, f))
    assert dt.max_bucket_bits == want.max_bucket_bits
    assert dt.key_words is None
    for f in ("pseq", "counter", "index", "start_index"):
        np.testing.assert_array_equal(_u32(dev[f]), getattr(dt, f))
    np.testing.assert_array_equal(dev["bucket_flagged"].numpy(),
                                  dt.bucket_flagged)


def test_uniq_builder(prepared):
    g, ht, pattern, dt, dev = prepared
    w0 = tdi.pack_key_words(padded_seq(g, pattern), ht.index, pattern)[:, 0]
    h_uw, h_uo, h_uc, h_bits = tdi.build_uniq_host(w0, ht.counter)
    uw, uo, uc, bits = tdi.build_uniq_device(
        dev["pseq"], dev["index"], dev["counter"], pattern,
        chunk=1 << 10,  # many chunks
    )
    assert bits == h_bits
    np.testing.assert_array_equal(_u32(uw), h_uw)
    np.testing.assert_array_equal(_u32(uo), h_uo)
    np.testing.assert_array_equal(_u32(uc), h_uc)
    # the JAX builder returns capacity arrays whose used prefix is the same
    j_uw, j_uo, j_uc, j_bits = jdi.build_uniq_device(
        jnp.asarray(dt.pseq), jnp.asarray(ht.index), jnp.asarray(ht.counter),
        pattern)
    U = len(h_uw)
    assert j_bits == bits
    np.testing.assert_array_equal(np.asarray(j_uw)[:U], _u32(uw))
    np.testing.assert_array_equal(np.asarray(j_uo)[: U + 1], _u32(uo))
    np.testing.assert_array_equal(np.asarray(j_uc), _u32(uc))


def test_uniq_budget(prepared):
    """The run arrays take 8(U + 1) bytes: that budget builds, less refuses."""
    g, ht, pattern, dt, dev = prepared
    args = (dev["pseq"], dev["index"], dev["counter"], pattern)
    U = int(tdi.build_uniq_device(*args)[0].shape[0])
    assert tdi.build_uniq_device(*args, max_bytes=8 * (U + 1)) is not None
    assert tdi.build_uniq_device(*args, max_bytes=8 * (U + 1) - 1) is None


def test_key16_builder(prepared):
    g, ht, pattern, dt, dev = prepared
    got = tdi.build_key16_device(dev["pseq"], dev["index"], pattern,
                                 chunk=1 << 11)
    want = np.asarray(jdi.build_key16_device(jnp.asarray(dt.pseq), ht.index,
                                             pattern))
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)


@pytest.mark.parametrize("n_key_words", [1, 3])
def test_key_words_builder(prepared, n_key_words):
    g, ht, pattern, dt, dev = prepared
    got = _u32(tdi.build_key_words_device(
        dev["pseq"], dev["index"], pattern, chunk=1 << 11,
        n_key_words=n_key_words))
    want = np.asarray(jdi.build_key_words_device(
        jnp.asarray(dt.pseq), ht.index, pattern, n_key_words=n_key_words))
    np.testing.assert_array_equal(got, want)
    host = tdi.pack_key_words(padded_seq(g, pattern), ht.index, pattern,
                              n_words=n_key_words)
    # host keys read the raw padded genome, the device ones the packed words:
    # they agree wherever no cared position runs past the genome end
    far = ht.index.astype(np.int64) + int(pattern.cared[-1]) < len(g.seq)
    np.testing.assert_array_equal(got[far], host[far])


def _one_pass_uniq(pseq, index, counter, pattern):
    """The uniq build as one pass over the whole table (whole-table word 0,
    breaks, int64 starts and searchsorted): the bounded build's reference."""
    import torch

    n = int(index.shape[0])
    offs = tdi._cared_offsets(pattern, tdi.POS_PER_WORD)
    w0 = tdi.packing.to_i32(
        tdi._cared_keys(pseq, index, offs, tdi.POS_PER_WORD, 0, n))
    breaks = torch.ones(n, dtype=torch.bool)
    torch.ne(w0[1:], w0[:-1], out=breaks[1:])
    cnt = counter.to(torch.int64)
    breaks[cnt[cnt < n]] = True
    starts = torch.nonzero(breaks).squeeze(1)
    uniq_off = torch.cat([starts, torch.full((1,), n)]).to(torch.int32)
    uniq_counter = torch.searchsorted(starts, cnt)
    mx = int((uniq_counter[1:] - uniq_counter[:-1]).max())
    return (w0[starts], uniq_off, uniq_counter.to(torch.int32),
            max(1, int(np.ceil(np.log2(mx + 1)))))


@pytest.fixture(scope="module")
def repeat_table():
    """A 100 kbp repeat-structured genome's CT00 table: its buckets hold
    word-0 runs longer than one entry, which a random genome's rarely do."""
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.synth import make_genome_repetitive

    pattern = get_pattern("3")
    conv, ht = build_table(make_genome_repetitive(100_000, n_chroms=2,
                                                  seed=5),
                           "CT00", pattern, verbose=False)
    dt = tdi.build_device_table(conv, ht, pattern)
    w0 = tdi.pack_key_words(padded_seq(conv, pattern), ht.index,
                            pattern)[:, 0]
    return ht, pattern, dt, tdi.place_table(dt, "cpu"), w0


def _chunk_cases(ht, w0):
    """(entries, chunk) of each case: chunk 1 on a prefix of the table (a
    CSR cut at n entries) that holds a multi-entry run, one that does not
    divide n, a bucket start on a chunk edge, a word-0 run that crosses a
    chunk edge, and one chunk for the whole table."""
    n = int(ht.index.shape[0])
    c = ht.counter.astype(np.int64)
    starts = c[(c > n // 4) & (c < n)]
    same = np.flatnonzero(w0[1:] == w0[:-1]) + 1
    same = same[~np.isin(same, c)]
    far = same[same > n // 4]
    odd = next(k for k in range(n // 7, n) if n % k)
    return {"1": (int(same[0]) + 64, 1), "odd": (n, odd),
            "bucket_edge": (n, int(starts[0])),
            "run_across": (n, int(far[0])), "whole": (n, n)}


@pytest.mark.parametrize("case", ["1", "odd", "bucket_edge", "run_across",
                                  "whole"])
def test_uniq_builder_chunked(repeat_table, case):
    """The bounded (two-pass, chunked) build equals the one-pass build and
    walt_tpu's runs at every chunk size."""
    import torch

    ht, pattern, dt, dev, w0 = repeat_table
    n, chunk = _chunk_cases(ht, w0)[case]
    index = dev["index"][:n]
    counter = torch.clamp(dev["counter"], max=n)
    want = _one_pass_uniq(dev["pseq"], index, counter, pattern)
    got = tdi.build_uniq_device(dev["pseq"], index, counter, pattern,
                                chunk=chunk)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(_u32(a), _u32(b))
    U = got[0].shape[0]
    assert U < n  # some runs hold several entries
    j = jdi.build_uniq_device(
        jnp.asarray(dt.pseq), jnp.asarray(ht.index[:n]),
        jnp.asarray(np.minimum(ht.counter, n)), pattern)
    assert j[3] == got[3]
    np.testing.assert_array_equal(np.asarray(j[0])[:U], _u32(got[0]))
    np.testing.assert_array_equal(np.asarray(j[1])[:U + 1], _u32(got[1]))
    np.testing.assert_array_equal(np.asarray(j[2]), _u32(got[2]))
    args = (dev["pseq"], index, counter, pattern)
    assert tdi.build_uniq_device(*args, max_bytes=8 * (U + 1),
                                 chunk=chunk) is not None
    assert tdi.build_uniq_device(*args, max_bytes=8 * (U + 1) - 1,
                                 chunk=chunk) is None


def test_uniq_build_time_tool_rehearses_on_cpu():
    """tools/uniq_build_time.py at a toy size on the CPU, with this tree as
    the other tree: every build's runs equal, one JSON line."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "uniq_build_time.py"),
         "--device", "cpu", "--bases", "300000", "--chunks", "4096,65536",
         "--reps", "1", "--other", root],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout.splitlines()[-1])
    assert rep["order"] == ["other", "chunk 4096", "chunk 65536",
                            "chunk 65536", "chunk 4096", "other"]
    assert all(len(v) == 2 for v in rep["seconds"].values())
    assert rep["entries"] > 290_000 and rep["device"] == "cpu"
