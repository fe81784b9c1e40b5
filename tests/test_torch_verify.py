"""The candidate-verify kernel (K1) of walt_tpu_torch against the JAX one.

- ``verify_windows_reference`` (the plain torch version the wrapper takes on
  CPU tensors) == walt_tpu's Pallas kernel in interpret mode and its jnp
  reference, including the clamp at the genome end and wrapped u32 starts;
- the per-row body ``csrc/verify_row.h``, built with g++, == the plain
  version (the CUDA kernel runs the same body);
- the wrapper refuses what the kernel does not take, and a machine without
  nvcc cannot build the kernel;
- the fused verify stage (``verify_worklist``): its per-row body
  ``csrc/verify_stage_row.h``, built with g++, == the plain version
  ``verify_worklist_reference`` on randomized worklists and on the stage
  inputs of every ``map_strand_core`` mode, whose outputs equal walt_tpu's.
"""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walt_tpu.ops import pallas_verify
from walt_tpu_torch import kernels
from walt_tpu_torch.ops import packing, verify


def _inputs(rng, M, W, Wg=400):
    """pseq (Wg,), gpos (M,), conv/lane (M, W) as numpy uint32."""
    pseq = rng.integers(0, 1 << 32, Wg, dtype=np.uint32)
    gpos = rng.integers(0, Wg * 16, M).astype(np.uint32)
    gpos[: min(M, 16)] = (Wg - 1) * 16 + np.arange(min(M, 16))  # clamp region
    if M > 20:
        gpos[16] = (Wg - W) * 16 + 7
        gpos[17:20] = [0x80000000, 0x9000000F, 0xFFFFFFF1]  # wrapped >= 2^31
        gpos[20:] = (gpos[20:] & ~np.uint32(15)) | (np.arange(M - 20) % 16)
    conv = rng.integers(0, 1 << 32, (M, W), dtype=np.uint32)
    lens = rng.integers(0, W * 16 + 1, M)
    lane = np.asarray(packing.len_lane_masks(torch.from_numpy(lens), W))
    return pseq, gpos, conv, lane.astype(np.uint32)


def _torch_args(pseq, gpos, conv, lane, device="cpu"):
    return [packing.from_np(a, device) for a in (pseq, gpos, conv, lane)]


@pytest.mark.parametrize("M,W", [(384, 7), (5, 3), (64, 13), (1000, 63)])
def test_reference_matches_pallas(M, W):
    rng = np.random.default_rng(42 + M)
    pseq, gpos, conv, lane = _inputs(rng, M, W)
    mm, win = verify.verify_windows_reference(
        *_torch_args(pseq, gpos, conv, lane), W)
    mm, win = mm.numpy(), win.numpy().view(np.uint32)

    # the JAX entry point (XLA gather + Pallas kernel, interpret mode)
    mm_p, win_p = pallas_verify.verify_windows(
        jnp.asarray(pseq), jnp.asarray(gpos), jnp.asarray(conv),
        jnp.asarray(lane), W=W, interpret=True)
    np.testing.assert_array_equal(mm, np.asarray(mm_p))
    np.testing.assert_array_equal(win, np.asarray(win_p))

    # the pre-gathered kernel and its jnp oracle
    word0 = (gpos >> 4).astype(np.int64)
    slices = pseq[np.minimum(word0[:, None] + np.arange(W + 1), len(pseq) - 1)]
    shift = ((gpos & 15) << 1).astype(np.uint32)
    args = tuple(map(jnp.asarray, (slices, shift, conv, lane)))
    for fn in (lambda *a: pallas_verify.verify_flat(*a, W=W, interpret=True),
               lambda *a: pallas_verify.verify_flat_reference(*a, W=W)):
        mm_j, win_j = fn(*args)
        np.testing.assert_array_equal(mm, np.asarray(mm_j))
        np.testing.assert_array_equal(win, np.asarray(win_j))


_SHIM = r"""
#include "verify_row.h"
extern "C" void verify_rows(const uint32_t* pseq, int64_t n_pseq,
                            const uint32_t* gpos, const uint32_t* conv,
                            const uint32_t* lane, int64_t M, int W,
                            int32_t* mm, uint32_t* win) {
  for (int64_t m = 0; m < M; ++m)
    waltx::verify_row(pseq, n_pseq, gpos[m], conv + m * W, lane + m * W, W,
                      mm + m, win + m * W);
}
"""


@pytest.fixture(scope="module")
def row_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    d = tmp_path_factory.mktemp("verify_row")
    src, so = d / "shim.cpp", d / "libverify_row.so"
    src.write_text(_SHIM)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-I", kernels.CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.verify_rows.argtypes = [p, ctypes.c_int64, p, p, p, ctypes.c_int64,
                                ctypes.c_int, p, p]
    lib.verify_rows.restype = None
    return lib


@pytest.mark.parametrize("M,W", [(777, 7), (300, 1), (90, 63)])
def test_row_body_gxx_matches_reference(row_lib, M, W):
    rng = np.random.default_rng(7 + M)
    pseq, gpos, conv, lane = _inputs(rng, M, W)
    mm = np.empty(M, np.int32)
    win = np.empty((M, W), np.uint32)
    row_lib.verify_rows(pseq.ctypes.data, len(pseq), gpos.ctypes.data,
                        conv.ctypes.data, lane.ctypes.data, M, W,
                        mm.ctypes.data, win.ctypes.data)
    mm_r, win_r = verify.verify_windows_reference(
        *_torch_args(pseq, gpos, conv, lane), W)
    np.testing.assert_array_equal(mm, mm_r.numpy())
    np.testing.assert_array_equal(win, win_r.numpy().view(np.uint32))


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(11)
    pseq, gpos, conv, lane = _torch_args(*_inputs(rng, 8, 3))
    with pytest.raises(TypeError):
        verify.verify_windows(pseq, gpos.to(torch.int64), conv, lane, 3)
    with pytest.raises(ValueError):
        verify.verify_windows(pseq, gpos, conv[:, :2], lane, 3)
    with pytest.raises(ValueError):
        verify.verify_windows(pseq, gpos, conv.t().contiguous().t(), lane, 3)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        verify.verify_windows(*(t.to("meta") for t in
                                (pseq, gpos, conv, lane)), 3)


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without nvcc the kernel library cannot be built, and asking for it
    raises instead of handing back anything else."""
    monkeypatch.setenv("PATH", os.defpath)
    monkeypatch.setenv("CUDA_HOME", "")
    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "LIB_PATH", "/nonexistent/libk.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.library()


@pytest.mark.parametrize("checkout", [True, False])
def test_kernel_build_dir(tmp_path, monkeypatch, checkout):
    """A checkout builds the kernels under its own build/; an installed copy
    (no pyproject.toml beside the package) builds in the user's cache."""
    import importlib.util

    root = tmp_path / "site"
    (root / "walt_tpu_torch").mkdir(parents=True)
    if checkout:
        (root / "pyproject.toml").write_text("")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    spec = importlib.util.spec_from_file_location(
        "kernels_copy", root / "walt_tpu_torch" / "kernels.py")
    mod = importlib.util.module_from_spec(spec)
    (root / "walt_tpu_torch" / "kernels.py").write_text(
        open(kernels.__file__).read())
    spec.loader.exec_module(mod)
    want = (root / "build" / "kernels" if checkout else
            tmp_path / "home" / ".cache" / "walt_tpu_torch" / "kernels")
    assert mod.BUILD_DIR == str(want)
    assert os.path.dirname(mod.LIB_PATH) == str(want)


# ---- the fused verify stage (verify_worklist, csrc/verify_stage.cu) ----

_STAGE_SHIM = r"""
#include "verify_stage_row.h"
template <int kW> static void rows(const waltx::StageArgs& a) {
  const int W = kW > 0 ? kW : a.W;
  for (int64_t m = 0; m < a.M; ++m) {
    const int64_t r = a.wl_read[m], seedi = a.wl_seedi[m];
    const auto f = waltx::stage_fetch<kW>(a, a.shifts, seedi,
                                          a.wl_entryidx[m]);
    waltx::stage_finish<kW>(a, f, a.start_index, a.cared_mask, a.cared_off,
                            a.conv + r * W, seedi, a.wl_valid[m] != 0,
                            a.lens[r], a.repeats[r], a.gpos + m, a.mm + m,
                            a.keep + m);
  }
}
extern "C" int stage_args_size() { return (int)sizeof(waltx::StageArgs); }
extern "C" void stage_rows(const waltx::StageArgs* a, int fixed) {
  if (!fixed) { rows<0>(*a); return; }
  switch (a->W) {
    case 1: rows<1>(*a); break;
    case 3: rows<3>(*a); break;
    case 5: rows<5>(*a); break;
    case 7: rows<7>(*a); break;
    case 13: rows<13>(*a); break;
    case 16: rows<16>(*a); break;
    default: rows<0>(*a);
  }
}
"""


@pytest.fixture(scope="module")
def stage_lib(tmp_path_factory):
    """The fused stage's per-row body (csrc/verify_stage_row.h) built with
    g++ into a library that runs it over every row on the CPU."""
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    d = tmp_path_factory.mktemp("verify_stage_row")
    src, so = d / "shim.cpp", d / "libverify_stage_row.so"
    src.write_text(_STAGE_SHIM)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-I", kernels.CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.stage_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.stage_rows.restype = None
    lib.stage_args_size.restype = ctypes.c_int
    return lib


def _stage_gxx(lib, args, kw, fixed=True):
    """The g++-built row body over every row of ``args`` (CPU tensors)."""
    M = args[0].shape[0]
    outs = (torch.empty(M, dtype=torch.int64),
            torch.empty(M, dtype=torch.int64),
            torch.empty(M, dtype=torch.bool))
    a = verify.stage_args(args, outs, **kw)
    lib.stage_rows(ctypes.addressof(a), int(fixed))
    return outs


def _assert_stage_equal(got, want, what=""):
    for name, g, w in zip(("gpos", "mm", "keep"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), f"{what} {name}"


def test_stage_args_layout_matches_header(stage_lib):
    assert stage_lib.stage_args_size() == ctypes.sizeof(verify.StageArgs)


# (M, B, W, stage_inputs options): the SE-like shape scaled down, every
# fixed W the tests instantiate, runtime W (20, 63, and 7 forced), key16's
# earlier cared check, the exact_b path (no cared check), phase A's one
# seed, many chromosomes, sparse reads
STAGE_CASES = {
    "word0": (3000, 2000, 7, {}),
    "key16": (3000, 2000, 7, dict(key16=True)),
    "exact_b": (3000, 2000, 7, dict(check=False)),
    "seed0": (2000, 2000, 7, dict(seeds=(0,))),
    "w1": (900, 600, 1, {}),
    "w3": (900, 600, 3, {}),
    "w13": (900, 600, 13, {}),
    "w16": (900, 600, 16, dict(key16=True)),
    "w20_runtime": (900, 600, 20, {}),
    "w63_runtime": (700, 400, 63, {}),
    "chroms3000": (2000, 1000, 7, dict(n_chroms=3000)),
    "sparse_reads": (600, 60_000, 7, {}),
    # genome positions past 2^31: one chromosome, and hg19's 93 contigs
    "past_2_31_one_chrom": (3000, 2000, 7, dict(straddle=True, n_chroms=1)),
    "past_2_31_93_chroms": (3000, 2000, 7, dict(straddle=True, n_chroms=93)),
    "past_2_31_key16": (2000, 1000, 13, dict(straddle=True, n_chroms=93,
                                             key16=True)),
    # seed patterns 5 (S = 5) and 7 (S = 7, cared_weight 4): no verify_skip
    "pattern5_w7": (3000, 2000, 7, dict(pattern="5")),
    "pattern7_w2": (900, 600, 2, dict(pattern="7")),
    "pattern7_w3": (900, 600, 3, dict(pattern="7")),
    "pattern7_w7": (3000, 2000, 7, dict(pattern="7")),
    "pattern7_exact_b": (3000, 2000, 7, dict(pattern="7", check=False)),
}


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_stage_row_body_gxx_matches_reference(stage_lib, case):
    """Randomized rows: shifts 0..30, the window clamp at the genome end,
    gpos >= 2^31, wrapped ok_head rows, ok_tail rows, verify_skip rows,
    reads shorter than 38 bp, key16 and exact_b cared checks."""
    M, B, W, opts = STAGE_CASES[case]
    rng = np.random.default_rng(100 + list(STAGE_CASES).index(case))
    from chip_smoke import stage_inputs

    args, kw = stage_inputs(rng, M, B, W, 4096, "cpu", **opts)
    want = verify.verify_worklist_reference(
        *args, **kw, windows=verify.verify_windows_reference)
    _assert_stage_equal(_stage_gxx(stage_lib, args, kw), want, case)
    if W == 7:  # the runtime-W instance on the same rows
        _assert_stage_equal(_stage_gxx(stage_lib, args, kw, fixed=False),
                            want, case + " runtime")
    keep, mm = want[2], want[1]
    assert 0 < int(keep.sum()) < M  # both outcomes occur
    if opts.get("straddle"):  # kept windows on both sides of 2^31
        kept = want[0][keep]
        assert (kept >= 1 << 31).any() and (kept < 1 << 31).any()
    assert int((mm <= kw["max_mm"]).sum()) > int(keep.sum()) or case in (
        "exact_b", "seed0")


def test_stage_reference_is_the_wrapper_on_cpu():
    """On CPU tensors verify_worklist is its plain version and launches
    nothing; it refuses what the kernel does not take."""
    rng = np.random.default_rng(3)
    from chip_smoke import stage_inputs

    args, kw = stage_inputs(rng, 500, 300, 7, 1024, "cpu")
    before = verify.stage_launches
    _assert_stage_equal(verify.verify_worklist(*args, **kw),
                        verify.verify_worklist_reference(*args, **kw))
    assert verify.stage_launches == before
    bad = list(args)
    bad[0] = args[0].to(torch.int32)
    with pytest.raises(ValueError, match="wl_read"):
        verify.verify_worklist(*bad, **kw)
    bad = list(args)
    bad[4] = args[4][:, :3].contiguous()
    with pytest.raises(ValueError, match="cared_mask"):
        verify.verify_worklist(*bad, **kw)
    bad = list(args)
    bad[9] = args[9].to(torch.int64)
    with pytest.raises(ValueError, match="start_index"):
        verify.verify_worklist(*bad, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        verify.verify_worklist(*(t.to("meta") for t in args), **kw)


# ---- the stage inside map_strand_core, in every mode, against walt_tpu ----

MODES = ["uniq", "word0", "key16", "exact_b", "emit_wl", "routed"]


def _mode_tables(dt, ht, pattern, mode):
    """(jax tables, torch tables, extra kwargs of each) of one mode."""
    import jax.numpy as jnp

    from walt_tpu.ops import device_index as jdi
    from walt_tpu_torch.ops import device_index as tdi

    order = ("pseq", "counter", "index", "key_words", "start_index",
             "bucket_flagged")
    jt = {k: jnp.asarray(np.asarray(getattr(dt, k))) for k in order
          if k != "key_words"}
    tt = tdi.place_table(dt, "cpu")
    jx, tx = {}, {}
    if mode in ("uniq", "emit_wl"):
        uw, uo, uc, bits = tdi.build_uniq_device(
            tt["pseq"], tt["index"], tt["counter"], pattern)
        tx = dict(uniq_words=uw, uniq_off=uo, uniq_counter=uc,
                  uniq_bits=bits)
        ju = jdi.build_uniq_device(jt["pseq"], jt["index"], jt["counter"],
                                   pattern)
        jx = dict(uniq_words=ju[0], uniq_off=ju[1], uniq_counter=ju[2],
                  uniq_bits=ju[3])
        jt["key_words"] = jnp.zeros((1, 1), jnp.uint32)
        tt["key_words"] = torch.zeros((1, 1), dtype=torch.int32)
    elif mode == "key16":
        jt["key_words"] = jdi.build_key16_device(jt["pseq"], ht.index,
                                                 pattern)
        tt["key_words"] = tdi.build_key16_device(tt["pseq"], tt["index"],
                                                 pattern)
    else:
        n = 3 if mode == "exact_b" else 1
        jt["key_words"] = jdi.build_key_words_device(
            jt["pseq"], ht.index, pattern, n_key_words=n)
        tt["key_words"] = tdi.build_key_words_device(
            tt["pseq"], tt["index"], pattern, n_key_words=n)
    return ([jt[k] for k in order], [tt[k] for k in order], jx, tx)


def _routed_tables(dt, pattern):
    """Shard 0 of a tp=2 uniq split, for key_base + tp_route."""
    import jax.numpy as jnp

    from walt_tpu_torch.ops import packing as tp
    from walt_tpu_torch.parallel import sharded as tsh

    st = tsh.shard_device_table(dt, 2, accel="uniq")
    table = [st.pseq, st.counter[0], st.index[0], np.zeros((1, 1), np.uint32),
             st.start_index, st.bucket_flagged[0]]
    uniq = [st.uniq_words[0], st.uniq_off[0], st.uniq_counter[0]]

    def tor(a):
        return torch.from_numpy(a) if a.dtype == np.uint8 else tp.from_np(a)

    names = ("uniq_words", "uniq_off", "uniq_counter")
    jx = dict(zip(names, (jnp.asarray(a) for a in uniq)),
              uniq_bits=st.uniq_bits, key_base=int(st.key_base[0]),
              tp_route=2)
    tx = dict(zip(names, (tor(a) for a in uniq)), uniq_bits=st.uniq_bits,
              key_base=int(st.key_base[0]), tp_route=2)
    return ([jnp.asarray(a) for a in table], [tor(a) for a in table], jx, tx)


@pytest.fixture(scope="module")
def mode_runs(my_index):
    """{mode: (walt_tpu's map_strand_core outputs, the port's, the port's
    verify_worklist calls as (args, kwargs, outputs))}, computed on first
    use."""
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.index import io_walt
    from walt_tpu_torch.ops import device_index as tdi
    from walt_tpu_torch.synth import sample_reads

    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(my_index)
    cache = {}

    def run(mode):
        if mode in cache:
            return cache[mode]
        import jax.numpy as jnp

        from walt_tpu.ops import pipeline as jpipe
        from walt_tpu_torch.ops import pipeline as tpipe

        ag = mode == "emit_wl"
        g, ht = io_walt.read_table_cached(
            my_index + ("_GA10" if ag else "_CT00"), gm)
        dt = tdi.build_device_table(g, ht, pattern,
                                    with_key_words=mode == "routed")
        codes, _, _ = sample_reads(g, 96, 100, seed=61)
        lens = np.random.default_rng(62).choice(
            [100, 100, 90, 80, 45, 30], 96).astype(np.int32)
        if ag:
            codes = np.ascontiguousarray((3 - codes)[:, ::-1])
        codes[np.arange(100)[None, :] >= lens[:, None]] = 0
        preads = packing.pack_codes_np(np.pad(codes, ((0, 0), (0, 12))))
        jtab, ttab, jx, tx = (_routed_tables(dt, pattern) if mode == "routed"
                              else _mode_tables(dt, ht, pattern, mode))
        b = 3 if mode == "exact_b" else 5000
        kw = dict(pattern_name="3", ag_wildcard=ag,
                  search_bits=dt.max_bucket_bits, exact_b=mode == "exact_b",
                  emit_wl=ag)
        want = jpipe.map_strand_core(
            jnp.asarray(preads), jnp.asarray(lens), jnp.int32(b),
            jnp.int32(6), *jtab, **kw, **jx)
        calls = []
        real = verify.verify_worklist

        def spy(*a, **k):
            out = real(*a, **k)
            calls.append((a, k, out))
            return out

        verify.verify_worklist = spy
        try:
            got = tpipe.map_strand_core(
                packing.from_np(preads), torch.from_numpy(lens), b, 6,
                *ttab, **kw, **tx)
        finally:
            verify.verify_worklist = real
        cache[mode] = (want, got, calls)
        return cache[mode]

    return run


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("mode", MODES)
def test_stage_in_map_strand_core_matches_jax(mode_runs, monkeypatch, mode):
    """map_strand_core reaches the verify stage through verify_worklist
    once per call (whose plain version runs on the CPU), and its outputs
    equal walt_tpu's, with the JAX verify kernel in interpret mode."""
    monkeypatch.setenv("WALTX_PALLAS", "1")
    want, got, calls = mode_runs(mode)
    assert len(calls) == 1
    if mode == "emit_wl":
        keep = _np(want[0][5])
        np.testing.assert_array_equal(_np(got[0][5]), keep)
        assert keep.sum() > 0
        for name, j, t in zip(("wl_read", "col", "pos", "mm", "shift"),
                              want[0], got[0]):
            np.testing.assert_array_equal(
                _np(t)[keep].astype(np.int64), _np(j)[keep].astype(np.int64),
                err_msg=name)
        want, got = want[1:], got[1:]
    for j, t in zip(want, got):
        np.testing.assert_array_equal(_np(t).astype(np.int64),
                                      _np(j).astype(np.int64))
    assert int(_np(calls[0][2][2]).sum()) > 0  # rows were kept


@pytest.mark.parametrize("mode", MODES)
def test_stage_row_body_on_pipeline_rows(mode_runs, stage_lib, mode):
    """The g++-built row body on the verify stage's real inputs of every
    mode equals what the plain version returned there."""
    _, _, calls = mode_runs(mode)
    args, kw, out = calls[0]
    _assert_stage_equal(_stage_gxx(stage_lib, args, kw), out, mode)
