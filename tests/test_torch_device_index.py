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
