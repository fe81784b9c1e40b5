"""walt_tpu_torch on an NVIDIA GPU: the CUDA kernel and the device pipeline.

Every test here needs a card (marker ``cuda``) and skips without one.  The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which pins JAX to the CPU.)
"""

import numpy as np
import pytest
import torch

from chip_smoke import stage_inputs, verify_inputs
from walt_tpu_torch.ops import verify


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,W", [(196_608, 7), (1001, 7), (5003, 1),
                                 (5003, 3), (5003, 13), (4097, 63)])
def test_verify_kernel_matches_reference(cuda_device, M, W):
    rng = np.random.default_rng(9 + M + W)
    args = verify_inputs(rng, M, W, 1 << 16, cuda_device)
    before = verify.launches
    mm_k, win_k = verify.verify_windows(*args, W)
    torch.cuda.synchronize(cuda_device)
    assert verify.launches == before + 1
    mm_r, win_r = verify.verify_windows_reference(*args, W)
    assert torch.equal(mm_k, mm_r)
    assert torch.equal(win_k, win_r)


@pytest.mark.cuda
@pytest.mark.parametrize("M,B,W,opts", [
    (196_608, 131_072, 7, {}), (393_216, 131_072, 7, {}),
    (5003, 3000, 7, dict(key16=True)), (5003, 3000, 7, dict(check=False)),
    (5003, 3000, 1, {}), (5003, 3000, 16, {}), (4097, 2000, 17, {}),
    (4097, 2000, 63, {}), (2000, 1000, 7, dict(n_chroms=3000)),
    (600, 60_000, 7, {}), (255, 100, 7, dict(seeds=(0,))),
    (5003, 3000, 7, dict(pattern="5")), (5003, 3000, 2, dict(pattern="7")),
    (5003, 3000, 3, dict(pattern="7")), (196_608, 131_072, 7,
                                         dict(pattern="7")),
    (5003, 3000, 7, dict(pattern="7", check=False)),
])
def test_verify_stage_kernel_matches_reference(cuda_device, M, B, W, opts):
    """The fused verify stage on the card equals its plain PyTorch version
    exactly, one launch per call."""
    rng = np.random.default_rng(M + B + W)
    args, kw = stage_inputs(rng, M, B, W, 1 << 16, cuda_device, **opts)
    before = verify.stage_launches
    got = verify.verify_worklist(*args, **kw)
    torch.cuda.synchronize(cuda_device)
    assert verify.stage_launches == before + 1
    want = verify.verify_worklist_reference(
        *args, **kw, windows=verify.verify_windows_reference)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_map_single_end_on_card_vs_native(cuda_device):
    """The whole SE step on the card agrees with the native exact replay on
    every read the device resolved, and went through the kernel."""
    from walt_tpu_torch import native
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.synth import make_genome_repetitive, sample_reads
    from walt_tpu_torch.core.torch_backend import TorchBackend

    pattern = get_pattern("3")
    genome = make_genome_repetitive(400_000, n_chroms=2, seed=17)
    tables = [build_table(genome, c, pattern, verbose=False)
              for c in ("CT00", "CT01")]
    codes, lens, _ = sample_reads(genome, 5000, 100, seed=23)
    backend = TorchBackend(device=cuda_device, small_chunk=1024)
    before = verify.stage_launches
    pos, times, minus, mm, fb = backend.map_single_end(
        codes, lens, tables, 5000, 6, pattern)
    assert verify.stage_launches > before
    ref = native.se_exact(codes, lens, tables, False, 5000, 6, pattern)
    if ref is None:
        pytest.skip("native library unavailable")
    ok = ~fb
    assert ok.mean() > 0.75
    for got, want in zip((pos, times, minus, mm), ref):
        np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.cuda
def test_map_mate_slabs_on_card_vs_native(cuda_device):
    """The PE mate step on the card, finalized natively, agrees with the
    native exact ranking and pair join on every pair the device resolved,
    and went through the kernel."""
    from chip_smoke import map_pairs_vs_exact
    from walt_tpu_torch import native
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.synth import make_genome_repetitive, sample_pairs
    from walt_tpu_torch.core.torch_backend import TorchBackend

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    pattern = get_pattern("3")
    genome = make_genome_repetitive(400_000, n_chroms=2, seed=17)
    tables = [[build_table(genome, c, pattern, verbose=False) for c in pair]
              for pair in (("CT00", "CT01"), ("GA10", "GA11"))]
    c1, l1, c2, l2 = sample_pairs(genome, 3000, 100, seed=23)
    backend = TorchBackend(device=cuda_device, small_chunk=1024)
    share, launches, _, _ = map_pairs_vs_exact(
        backend, [(c1, l1), (c2, l2)], tables,
        genome.start_index.astype(np.uint32))
    assert launches["verify_worklist"] > 0
    assert share > 0.75


def _in_thread(fn):
    """fn() on a worker thread, as the SE and PE drivers call the backend
    (the current CUDA device is per thread); returns its result."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised on the test's thread
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=600)
    assert not t.is_alive()
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.mark.cuda
def test_verify_kernel_on_second_card_from_worker_thread(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev1 = torch.device("cuda", 1)
    args = verify_inputs(np.random.default_rng(5), 5003, 7, 1 << 16, dev1)
    mm_k, win_k = _in_thread(lambda: verify.verify_windows(*args, 7))
    torch.cuda.synchronize(dev1)
    mm_r, win_r = verify.verify_windows_reference(*args, 7)
    assert mm_k.device == dev1
    assert torch.equal(mm_k, mm_r) and torch.equal(win_k, win_r)


@pytest.mark.cuda
def test_mesh_on_card_matches_single_device(cuda_device):
    """A dp=2 x tp=2 mesh (over the cards, or virtual over one card),
    called from a worker thread: SE and PE results equal the single-device
    backend's wherever neither fell back, through the kernel."""
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.synth import make_genome_repetitive, sample_pairs
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    devices = ([torch.device("cuda", i % n) for i in range(4)] if n >= 2
               else [cuda_device] * 4)
    mesh = make_mesh(devices, tp=2)
    pattern = get_pattern("3")
    genome = make_genome_repetitive(400_000, n_chroms=2, seed=17)
    tables = [[build_table(genome, c, pattern, verbose=False) for c in pair]
              for pair in (("CT00", "CT01"), ("GA10", "GA11"))]
    c1, l1, c2, l2 = sample_pairs(genome, 3000, 100, seed=23)
    mesh_b = TorchBackend(mesh=mesh, small_chunk=1024)
    single = TorchBackend(device=cuda_device, small_chunk=1024)
    before = verify.stage_launches
    got = _in_thread(lambda: mesh_b.map_single_end(c1, l1, tables[0], 5000,
                                                   6, pattern))
    assert verify.stage_launches > before
    want = single.map_single_end(c1, l1, tables[0], 5000, 6, pattern)
    ok = ~(got[4] | want[4])
    assert ok.mean() > 0.75
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g[ok], w[ok])
    for codes, lens, tabs, ag in ((c1, l1, tables[0], False),
                                  (c2, l2, tables[1], True)):
        ms, mfb = _in_thread(lambda: mesh_b.map_mate_slabs(
            codes, lens, tabs, ag, 5000, 6, pattern))
        ss, sfb = single.map_mate_slabs(codes, lens, tabs, ag, 5000, 6,
                                        pattern)
        ok = ~(mfb | sfb)
        assert ok.mean() > 0.6
        for st, sst in zip(ms, ss):
            for k in ("cnt", "seed", "pos", "mm"):
                np.testing.assert_array_equal(st[k][ok], sst[k][ok])


@pytest.mark.cuda
def test_verify_stage_on_second_card_keeps_current_device(cuda_device):
    """A fused-stage launch on cuda:1 from the main thread leaves the
    thread's current device as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev1 = torch.device("cuda", 1)
    args, kw = stage_inputs(np.random.default_rng(11), 5003, 3000, 7,
                            1 << 16, dev1)
    current = torch.cuda.current_device()
    got = verify.verify_worklist(*args, **kw)
    assert torch.cuda.current_device() == current
    torch.cuda.synchronize(dev1)
    want = verify.verify_worklist_reference(
        *args, **kw, windows=verify.verify_windows_reference)
    for g, w in zip(got, want):
        assert g.device == dev1 and torch.equal(g, w)


@pytest.mark.cuda
def test_dp_mesh_on_cards_equals_serial_chunks(cuda_device):
    """A dp=2 x tp=1 mesh over two cards (virtual on one card when there is
    one), each row on its own thread: its SE step equals the single-device
    step over the two chunks of half the reads, element for element, with
    the same fused-stage launches, and the caller's current device stays."""
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.ops import se_fold
    from walt_tpu_torch.parallel import make_mesh, sharded
    from walt_tpu_torch.synth import make_genome_repetitive, sample_reads

    n_cards = torch.cuda.device_count()
    mesh = make_mesh([torch.device("cuda", i % n_cards) for i in range(2)],
                     tp=1)
    pattern = get_pattern("3")
    genome = make_genome_repetitive(400_000, n_chroms=2, seed=17)
    tables = [build_table(genome, c, pattern, verbose=False)
              for c in ("CT00", "CT01")]
    codes, lens, _ = sample_reads(genome, 8192, 100, seed=29)
    kw = dict(pattern_name="3", ag_wildcard=False, verify_slab=8,
              cand_slab=32, wl_factor=1.5)

    def step(backend, chunk):
        tabs, bits, ubits = [], [], []
        for g, ht in tables:
            dt, dev = backend._device_table(g, ht, pattern, 1)
            tabs.append(dev)
            bits.append(dt.max_bucket_bits)
            ubits.append(dt.uniq_bits)
        fn = (se_fold.map_single_end_device if backend.mesh is None else
              lambda *a, **k: sharded.map_single_end_sharded(
                  *a, mesh=backend.mesh, **k))
        before = verify.stage_launches
        out = [fn(pc, pl, 5000, 6, tuple(tabs), search_bits=tuple(bits),
                  uniq_bits=tuple(ubits), **kw)
               for _, _, pc, pl in backend._chunks(codes, lens, pattern,
                                                   chunk)]
        for d in mesh.distinct():
            torch.cuda.synchronize(d)
        return torch.cat([o.cpu() for o in out]), verify.stage_launches - \
            before

    current = torch.cuda.current_device()
    got, got_launches = step(TorchBackend(mesh=mesh), 8192)
    assert torch.cuda.current_device() == current
    want, want_launches = step(TorchBackend(device=cuda_device), 4096)
    assert got_launches == want_launches > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_dryrun_multichip_on_card(cuda_device):
    from walt_tpu_torch import entry

    out = entry.dryrun_multichip(4)
    assert out["unique"] > 0 and out["unique_pairs"] > 0


def _graph_setup(device, n_reads=4096):
    """A backend on ``device`` with the CT tables of a small genome placed,
    two chunks of reads on the card, and the SE and PE step arguments."""
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.ops import pe_map
    from walt_tpu_torch.synth import make_genome_repetitive, sample_reads

    pattern = get_pattern("3")
    genome = make_genome_repetitive(400_000, n_chroms=2, seed=17)
    tables = [build_table(genome, c, pattern, verbose=False)
              for c in ("CT00", "CT01")]
    backend = TorchBackend(device=device)
    built = [backend._device_table(g, ht, pattern, 1) for g, ht in tables]
    codes, lens, _ = sample_reads(genome, 2 * n_reads, 100, seed=31)
    chunks = [(pc, pl) for _, _, pc, pl in
              backend._chunks(codes, lens, pattern, n_reads)]
    common = dict(pattern_name="3", ag_wildcard=False,
                  search_bits=tuple(dt.max_bucket_bits for dt, _ in built),
                  uniq_bits=tuple(dt.uniq_bits for dt, _ in built),
                  cand_slab=backend.cand_slab, full_mask=True)
    se_kw = dict(common, verify_slab=8, wl_factor=1.5)
    pe_kw = dict(common, verify_slab=pe_map.VERIFY_SLAB,
                 wl_factor=pe_map.WL_FACTOR, flat_factor=pe_map.FLAT_FACTOR)
    return backend, tuple(d for _, d in built), chunks, se_kw, pe_kw


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["se", "pe"])
def test_graph_replay_equals_eager_step(cuda_device, mode):
    """The cached step (a CUDA graph replay) equals the eager step bit for
    bit on two chunks, and each replay counts the graph's captured
    fused-stage launches, as many as the eager step makes."""
    from walt_tpu_torch.ops import pe_map, se_fold
    from walt_tpu_torch.ops import stages as st

    backend, devs, chunks, se_kw, pe_kw = _graph_setup(cuda_device)
    step, body, kw = ((backend.se_step, se_fold.map_single_end_device, se_kw)
                      if mode == "se" else
                      (backend.mate_step, pe_map.map_mate_device, pe_kw))
    for pc, pl in chunks:
        before = verify.stage_launches
        want = _outs(body(pc, pl, 5000, 6, devs, stages=st.StageLog(), **kw))
        per_call = verify.stage_launches - before
        got = tuple(t.clone() for t in _outs(step(pc, pl, 5000, 6, devs,
                                                  **kw)))
        torch.cuda.synchronize(cuda_device)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    (entry,) = backend.graphs._entries.values()
    assert entry.launches == {"stage_launches": per_call} and per_call == 2
    k, before, k1 = 5, verify.stage_launches, verify.launches
    for _ in range(k):
        step(*chunks[0], 5000, 6, devs, **kw)
    assert verify.stage_launches - before == k * per_call
    assert verify.launches == k1  # K1 stays off the path
    stats = backend.graphs.stats()[str(cuda_device)]
    assert stats["graphs"] == 1 and stats["pool_bytes"] > 0


@pytest.mark.cuda
def test_graph_replay_on_second_card_keeps_current_device(cuda_device):
    """A step captured and replayed on cuda:1 from the main thread leaves
    the thread's current device as it was, and equals the eager step."""
    from walt_tpu_torch.ops import se_fold

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev1 = torch.device("cuda", 1)
    backend, devs, chunks, se_kw, _ = _graph_setup(dev1)
    current = torch.cuda.current_device()
    assert current != 1
    for pc, pl in chunks:
        got = backend.se_step(pc, pl, 5000, 6, devs, **se_kw).clone()
        assert torch.cuda.current_device() == current
        want = se_fold.map_single_end_device(pc, pl, 5000, 6, devs, **se_kw)
        torch.cuda.synchronize(dev1)
        assert got.device == dev1 and torch.equal(got, want)


@pytest.mark.cuda
def test_out_of_memory_in_capture_is_a_budget_error(cuda_device,
                                                    monkeypatch):
    """A real out-of-memory error raised while a step is being captured
    (the step asks the caching allocator for 1 TiB under capture) ends the
    capture, reaches the caller as HbmBudgetError, and the backend's next
    call captures its steps and maps as a fresh backend does."""
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.core.errors import HbmBudgetError
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.index.build import build_table
    from walt_tpu_torch.ops import se_fold
    from walt_tpu_torch.synth import make_genome_repetitive, sample_reads

    pattern = get_pattern("3")
    genome = make_genome_repetitive(400_000, n_chroms=2, seed=17)
    tables = [build_table(genome, c, pattern, verbose=False)
              for c in ("CT00", "CT01")]
    codes, lens, _ = sample_reads(genome, 3000, 100, seed=37)
    real = se_fold.map_single_end_device
    captured = []

    def greedy(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            captured.append(True)
            torch.empty(1 << 40, dtype=torch.uint8, device=cuda_device)
        return real(*a, **k)

    backend = TorchBackend(device=cuda_device, small_chunk=1024)
    monkeypatch.setattr(se_fold, "map_single_end_device", greedy)
    with pytest.raises(HbmBudgetError):
        backend.map_single_end(codes, lens, tables, 5000, 6, pattern)
    assert captured and not torch.cuda.is_current_stream_capturing()
    assert len(backend.graphs) == 0
    monkeypatch.setattr(se_fold, "map_single_end_device", real)
    got = backend.map_single_end(codes, lens, tables, 5000, 6, pattern)
    assert len(backend.graphs)
    want = TorchBackend(device=cuda_device, small_chunk=1024).map_single_end(
        codes, lens, tables, 5000, 6, pattern)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
