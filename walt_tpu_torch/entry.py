"""Entry points of the port: a one-table mapping step and a multi-device
dry run.

Port of ``__graft_entry__.py`` (``entry`` and ``dryrun_multichip``).  Both
run on the card unless the caller names other devices: the dry run takes
``["cpu"] * n``, a virtual mesh over one card (``["cuda:0"] * n``) and real
cards alike, and with no devices given it refuses to run without a card.
"""

from __future__ import annotations

import numpy as np
import torch

from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.index.build import build_table
from walt_tpu_torch.synth import make_genome, sample_pairs, sample_reads
from walt_tpu_torch.core.torch_backend import TorchBackend
from walt_tpu_torch.ops import device_index, packing, pipeline
from walt_tpu_torch.parallel import make_mesh


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def entry(device="cuda"):
    """(fn, example_args): one mapping step of a packed bisulfite read
    batch against one converted-genome table (seed hash -> bucket refine ->
    verify -> compact), on ``device`` (``"cpu"`` must be asked for);
    ``fn(*example_args)`` returns the candidate slabs of
    ``pipeline.map_strand_core``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    pattern = get_pattern("3")
    genome = make_genome(200_000, seed=0)
    conv, table = build_table(genome, "CT00", pattern, verbose=False)
    dt = device_index.build_device_table(conv, table, pattern,
                                         with_key_words=True)
    read_len = 96
    codes, lens, _ = sample_reads(genome, 256, read_len)
    W = (read_len + 15) // 16
    preads = packing.pack_codes_np(
        np.pad(codes, ((0, 0), (0, W * 16 - read_len))))
    dev = device_index.place_table(dt, device)

    def fn(preads, lens, pseq, counter, index, key_words, start_index,
           bucket_flagged):
        return pipeline.map_strand_core(
            preads, lens, 5000, 6, pseq, counter, index, key_words,
            start_index, bucket_flagged, pattern_name="3", ag_wildcard=False,
            search_bits=dt.max_bucket_bits,
        )

    example_args = (
        packing.from_np(preads, device), torch.from_numpy(lens).to(device),
        dev["pseq"], dev["counter"], dev["index"], dev["key_words"],
        dev["start_index"], dev["bucket_flagged"],
    )
    return fn, example_args


def _default_devices(n: int) -> list:
    """n CUDA cards when there are that many, else a virtual mesh over the
    first card; raises when there is no card (the CPU must be asked for)."""
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n_cuda:
        raise RuntimeError("dryrun_multichip: no CUDA device is available; "
                           "pass devices=['cpu'] * n to run on the CPU")
    if n_cuda >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def _mapstats(mesh, times, fb, lens, pattern) -> np.ndarray:
    """[unique, ambiguous, unmapped, too_short] summed over the dp rows: each
    row counts its own reads on its first device, and the rows' vectors are
    summed on the mesh's first device (walt_tpu's psum over dp)."""
    dp = mesh.shape["dp"]
    bl = times.shape[0] // dp
    parts = []
    for d in range(dp):
        dev = mesh.devices[d][0]
        t, f, ln = (torch.from_numpy(np.ascontiguousarray(x[d * bl:
                                                            (d + 1) * bl]))
                    .to(dev) for x in (times, fb, lens))
        short = ln < pattern.min_read_len
        counted = ~f & ~short
        parts.append(torch.stack([
            (counted & (t == 1)).sum(), (counted & (t >= 2)).sum(),
            (counted & (t == 0)).sum(),
            2 * short.sum(),  # counted once per strand pass
        ]).to(mesh.devices[0][0]))
    return torch.stack(parts).sum(0).cpu().numpy()


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the production multi-device mapping step over an n-device mesh.

    Builds the backend the CLI uses (``TorchBackend``) on a (dp, tp) mesh
    over ``devices`` (default :func:`_default_devices`): reads split over
    dp, each table over tp by bucket range, shard summaries combined, the
    BestMatch fold, and the mapstats vector summed over dp.  Holds the
    sharded results equal to the single-device backend's wherever neither
    side fell back, for SE reads and for both mates of PE pairs (the C->T
    tables for mate 1, the G->A tables with A/G wildcards for mate 2),
    whose slabs ``native.pe_finalize`` then joins.  Returns the counts it
    printed.
    """
    devices = list(_default_devices(n_devices) if devices is None
                   else devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    mesh = make_mesh(devices)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]

    pattern = get_pattern("3")
    genome = make_genome(120_000, n_chroms=2, seed=3)
    built = {conv: build_table(genome, conv, pattern, verbose=False)
             for conv in ("CT00", "CT01", "GA10", "GA11")}
    tables = [built["CT00"], built["CT01"]]  # SE / PE mate 1 ('+', '-')
    ga_tables = [built["GA10"], built["GA11"]]  # PE mate 2 (A/G wildcard)
    codes, lens, _ = sample_reads(genome, 64 * dp, 64, seed=5)

    backend = TorchBackend(mesh=mesh)
    single = TorchBackend(device=devices[0])
    pos, times, minus, mm, fb = backend.map_single_end(
        codes, lens, tables, b=5000, max_mismatches=6, pattern=pattern)
    s_pos, s_times, s_minus, s_mm, s_fb = single.map_single_end(
        codes, lens, tables, b=5000, max_mismatches=6, pattern=pattern)
    ok = ~(fb | s_fb)
    _check(ok.sum() >= len(lens) - 2, f"too many fallbacks: {int(fb.sum())}")
    for name, a, c in (("pos", pos, s_pos), ("times", times, s_times),
                       ("minus", minus, s_minus), ("mm", mm, s_mm)):
        _check(np.array_equal(a[ok], c[ok]), f"sharded {name} != single")

    stats = _mapstats(mesh, times, fb, lens, pattern)
    short_h = lens < pattern.min_read_len
    counted_h = ~fb & ~short_h
    expect = [int((counted_h & (times == 1)).sum()),
              int((counted_h & (times >= 2)).sum()),
              int((counted_h & (times == 0)).sum()),
              2 * int(short_h.sum())]
    _check(stats.tolist() == expect, f"dp-summed mapstats {stats} != {expect}")

    c1, l1, c2, l2 = sample_pairs(genome, 64 * dp, 64, seed=9)
    streams4, s_streams4, skips = [], [], []
    for codes_m, lens_m, tabs, ag in ((c1, l1, tables, False),
                                      (c2, l2, ga_tables, True)):
        ms, mfb = backend.map_mate_slabs(codes_m, lens_m, tabs, ag, 5000, 6,
                                         pattern)
        ss, sfb = single.map_mate_slabs(codes_m, lens_m, tabs, ag, 5000, 6,
                                        pattern)
        pe_ok = ~(mfb | sfb)
        _check(pe_ok.sum() >= len(lens_m) - 2, "too many PE fallbacks")
        for st, sst in zip(ms, ss):
            for k in ("cnt", "seed", "pos", "mm"):
                _check(np.array_equal(st[k][pe_ok], sst[k][pe_ok]),
                       f"PE {k} (ag={ag})")
        streams4 += ms
        s_streams4 += ss
        skips.append(mfb | sfb)

    from walt_tpu_torch import native

    skip = (skips[0] | skips[1]).astype(np.uint8)
    args = (skip, l1.astype(np.int32), l2.astype(np.int32),
            genome.start_index.astype(np.uint32), 50, 1000, 6,
            pattern.exit1_seed)
    fin = native.pe_finalize(streams4, *args)
    n_pairs = 0
    if fin is None:
        print("dryrun_multichip: native library unavailable; pe_finalize "
              "skipped")
    else:
        s_fin = native.pe_finalize(s_streams4, *args)
        for k in fin:
            _check(np.array_equal(fin[k], s_fin[k]), f"pe_finalize {k}")
        n_pairs = int((fin["code"] == 0).sum())  # 0 = unique pair
        _check(n_pairs > 0, "no unique pairs joined in the dry-run workload")

    out = dict(dp=dp, tp=tp, reads=len(lens), mapstats=stats.tolist(),
               unique=expect[0], fallback=int(fb.sum()), pairs=len(l1),
               unique_pairs=n_pairs)
    print(f"dryrun_multichip: TorchBackend on mesh dp={dp} tp={tp} over "
          f"{mesh.distinct()}, {len(lens)} SE reads (dp-summed mapstats "
          f"{stats.tolist()}, {expect[0]} unique, {int(fb.sum())} "
          f"host-fallback) + {len(l1)} pairs both conversions "
          f"({n_pairs} unique pairs via native finalize): sharded == "
          f"single-device everywhere")
    return out
