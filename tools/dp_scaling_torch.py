"""dp and tp scaling of walt_tpu_torch's SE step, on one or more CUDA GPUs.

Port of ``tools/dp_scaling.py``.  walt_tpu measured on virtual CPU devices,
which run one after another, so it reported the partition overhead a
parallel mesh would pay, not a speedup.  This tool measures the port's
mesh on H100 cards: each dp row of a mesh runs on its own host thread
(``parallel.sharded.Mesh.run_rows``), as every shard of walt_tpu's one
``shard_map`` program runs at once, and replays its CUDA graphs
(``ops/graphs``; the first call of each mesh size captures them).

For each mesh size nd in 1, 2, 4 and 8 it maps ``n`` reads sampled afresh
from the index's genome (``synth.sample_reads(genome, n, 100, seed=5 +
nd)``, walt_tpu's seeds) with backends of ``chunk = n``, ``-m 6 -b 5000``.
The mesh is dp=nd x tp=1 over ``cuda:0..nd-1`` when the machine has nd
cards (``"virtual": false``), else nd rows on ``cuda:0`` (``"virtual":
true``): rows on one card launch onto its one stream, which is walt_tpu's
serial-virtual-device method.  Each number is the best of ``REPS`` calls
after a warm one, every device synchronized by name:

- ``reads_per_s``: ``TorchBackend(mesh=...).map_single_end`` end to end
  (on a mesh the SE slab tiers run, on one card the host replays), and
  ``end_to_end_vs_1dev`` against nd = 1;
- ``device_program_reads_per_s``: the tier-1 SE step over all ``n`` reads
  as one chunk, ``map_single_end_sharded`` (``map_single_end_device`` at
  nd = 1);
- ``serial_chunks_reads_per_s``: the single-device step over nd chunks of
  n/nd reads, and ``implied_dp_efficiency = min(t_serial / t_sharded,
  1)``, which reads as walt_tpu's on a virtual mesh;
- on real meshes ``speedup_vs_1dev`` (the device program on nd cards
  against one) and ``dp_efficiency = speedup / nd``;
- ``launches`` and ``serial_launches``: each kernel's launches in one
  device-program call and in one pass over the serial chunks;
- ``peak_gib_per_card``: peak allocated memory per card over the
  device-program calls, tables included;
- ``results_equal``: the dp program's (n, 3) result equals the serial
  chunks' results, element for element (tp = 1: the tables are
  replicated and each row has a chunk's shape);
- ``fallback``: reads of the last end-to-end call that fell back.

``tp_cost`` (walt_tpu's) runs the device program at tp = 1 and tp = 2 on
the same tables, one dp row (``implied_tp_efficiency = t_tp1 / t_tp2``),
on a virtual mesh and, with two or more cards, over two; and times the
legacy slab merge (``merge_gathered`` after the copy that stands in for
the ``all_gather``) on random slab-shaped inputs, times the number of
tables, and its share of the tp = 2 program.

Usage, from the repository root:

    python tools/dp_scaling_torch.py [index] [n] [--device cuda|cpu]
        [--out PATH]

Defaults: ``chip_smoke.py``'s 128 Mbp index under ``build/smoke_data/``
(built when missing), n = 524,288 (four of its 131,072-read main-path
chunks: at dp = 4 each row maps one).  The genome is rebuilt from the
index's forward C->T and G->A tables.  One JSON line per row; the last
line is the report ``{"n", "reps", "results", "cards", "card"}`` (``card``:
nvidia-smi's name and power limit of each card), which a card run also
writes to
``SCALING_TORCH.json`` at the repository root (``--out`` elsewhere).
``--device cpu`` is a rehearsal at a toy size: without an index it builds
walt_tpu's tool's genome (8 Mbp, 2 chromosomes, seed 3), maps 256 reads on
``["cpu"] * nd`` meshes, prints every key with no measured number and
writes nothing.  There is no fallback from the card to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

MESH_SIZES = (1, 2, 4, 8)
#: reads per mesh size on a card: four 131,072-read main-path chunks
N_READS = 524_288
#: reads per mesh size in the CPU rehearsal
N_REHEARSAL = 256
#: the CPU rehearsal's genome without an index, walt_tpu's tool's
REHEARSAL_BASES = 8_000_000
REPS = 5
READ_LEN = 100
B, MAX_MM = 5000, 6
#: keys of a report row that hold a measured number (None in a rehearsal)
MEASURED = ("reads_per_s", "end_to_end_vs_1dev", "device_program_reads_per_s",
            "serial_chunks_reads_per_s", "implied_dp_efficiency",
            "speedup_vs_1dev", "dp_efficiency", "peak_gib_per_card",
            "device_program_s", "implied_tp_efficiency",
            "legacy_slab_merge_s", "legacy_slab_merge_share")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("args", nargs="*", metavar="[index] [n]")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=os.path.join(REPO, "SCALING_TORCH.json"))
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():  # before any data is built
            p.exit(1, f"{p.prog}: no CUDA device (use --device cpu for the "
                      f"rehearsal)\n")
    rest = list(args.args)
    args.n = (int(rest.pop()) if rest and rest[-1].isdigit() else
              N_READS if args.device == "cuda" else N_REHEARSAL)
    if len(rest) > 1:
        p.error("give at most an index and n")
    args.index = rest[0] if rest else None
    if args.n <= 0 or args.n % max(MESH_SIZES):
        p.error(f"n must be a positive multiple of {max(MESH_SIZES)}")
    return args


def index_genome(index: str):
    """The forward genome of a WALT index: the C->T table's sequence, with
    C where it reads T and the G->A table's reads C."""
    import dataclasses

    import numpy as np

    from walt_tpu_torch.index import io_walt

    gm, _ = io_walt.read_head(index)
    ct, _ = io_walt.read_table_cached(index + "_CT00", gm)
    ga, _ = io_walt.read_table_cached(index + "_GA10", gm)
    seq = np.where((ct.seq == 3) & (ga.seq == 1), np.uint8(1), ct.seq)
    return dataclasses.replace(gm, seq=seq.astype(np.uint8), strand="+")


def index_tables(index: str):
    """The index's CT00 and CT01 tables, as the SE driver reads them."""
    from walt_tpu_torch.index import io_walt

    gm, _ = io_walt.read_head(index)
    return [io_walt.read_table_cached(f"{index}_{c}", gm)
            for c in ("CT00", "CT01")]


def sync(devices) -> None:
    import torch

    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def best_of(fn, reps: int, devices):
    """(best seconds of ``reps`` calls of ``fn`` after a warm one, each
    ending with every device synchronized; the last call's result)."""
    out = fn()
    sync(devices)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(devices)
        best = min(best, time.perf_counter() - t0)
    return best, out


def launches_of(fn, devices):
    """(fn(), each kernel's launches during the call)."""
    before = cs.counts()
    out = fn()
    sync(devices)
    return out, {k: v - before[k] for k, v in cs.counts().items()}


def mesh_devices(nd: int, device):
    """(nd devices, virtual): the first nd cards when there are as many,
    else nd times ``device`` (the CPU, or the first card)."""
    import torch

    if device.type == "cuda" and torch.cuda.device_count() >= nd:
        return [torch.device("cuda", i) for i in range(nd)], False
    return [device] * nd, nd > 1


class Scaling:
    """``n`` reads per mesh size, the tables, the pattern and a
    single-device backend (its tables placed once; nd = 1 and every serial
    baseline run on it)."""

    def __init__(self, tables, n: int, device, reps: int,
                 end_to_end: bool = True):
        from walt_tpu_torch.constants import get_pattern
        from walt_tpu_torch.core.torch_backend import TorchBackend

        self.tables = tables
        self.n = n
        self.device = device
        self.reps = reps
        self.end_to_end = end_to_end
        self.pattern = get_pattern("3")
        self.single = TorchBackend(device=device, chunk=n, small_chunk=n)
        # the tier-1 step at the backend's knobs as made, before a batch
        # widens them
        self.step_kw = dict(
            pattern_name=self.pattern.name, ag_wildcard=False, seeds=None,
            verify_slab=self.single.verify_slab_t1,
            cand_slab=self.single.cand_slab, wl_factor=self.single._wl1,
            exact_b=False)

    def backend(self, mesh=None):
        """A backend whose chunk is all ``n`` reads: on ``mesh``, or the
        single-device one with its adaptive state reset."""
        from walt_tpu_torch.core.torch_backend import TorchBackend

        if mesh is None:
            self.single.reset_adaptive()
            return self.single
        return TorchBackend(mesh=mesh, chunk=self.n, small_chunk=self.n)

    def program(self, backend, codes, lens, chunk: int):
        """The SE tier-1 step of ``backend`` over ``codes`` in chunks of
        ``chunk`` reads (``backend.se_step``: graph replays on a card): a
        function returning each chunk's (chunk, 3) result, copied out of
        the graph's outputs as the backend copies them."""
        tabs, bits, ubits = [], [], []
        for g, ht in self.tables:
            dt, dev = backend._device_table(g, ht, self.pattern, 1)
            tabs.append(dev)
            bits.append(dt.max_bucket_bits)
            ubits.append(dt.uniq_bits)
        chunks = [(pc, pl) for _, _, pc, pl in
                  backend._chunks(codes, lens, self.pattern, chunk)]

        def run():
            return [backend.se_step(pc, pl, B, MAX_MM, tuple(tabs),
                                    search_bits=tuple(bits),
                                    uniq_bits=tuple(ubits),
                                    **self.step_kw).clone()
                    for pc, pl in chunks]

        return run

    def dp_row(self, genome, nd: int, base: dict | None) -> dict:
        """One mesh size's report row (``base``: the nd = 1 row)."""
        import torch

        from walt_tpu_torch.parallel import make_mesh
        from walt_tpu_torch.synth import sample_reads

        n = self.n
        codes, lens, _ = sample_reads(genome, n, READ_LEN, seed=5 + nd)
        devices, virtual = mesh_devices(nd, self.device)
        mesh = make_mesh(devices, tp=1) if nd > 1 else None
        backend = self.backend(mesh)
        try:
            if self.end_to_end:
                t_e2e, out = best_of(lambda: backend.map_single_end(
                    codes, lens, self.tables, B, MAX_MM, self.pattern),
                    self.reps, devices)
            prog = self.program(backend, codes, lens, n)
            serial = self.program(self.single, codes, lens, n // nd)
            cs.peak_gib(devices, reset=True)
            t_prog, dp_out = best_of(prog, self.reps, devices)
            peaks = peak_gib(devices)
            dp_out, launches = launches_of(prog, devices)
            t_serial, _ = best_of(serial, self.reps, [self.device])
            serial_out, serial_launches = launches_of(serial, [self.device])
            equal = torch.equal(
                dp_out[0].cpu(), torch.cat([r.cpu() for r in serial_out]))
        finally:
            if mesh is not None:
                backend.free_tables()
        rps = n / t_e2e if self.end_to_end else None
        drps = n / t_prog
        base = base or dict(reads_per_s=rps, device_program_reads_per_s=drps)
        real = not virtual
        speedup = drps / base["device_program_reads_per_s"] if real else None
        return dict(
            devices=nd, virtual=virtual, reads_per_s=rps,
            end_to_end_vs_1dev=(None if rps is None
                                else rps / base["reads_per_s"]),
            device_program_reads_per_s=drps,
            serial_chunks_reads_per_s=n / t_serial,
            implied_dp_efficiency=min(t_serial / t_prog, 1.0),
            speedup_vs_1dev=speedup,
            dp_efficiency=speedup / nd if real else None,
            fallback=int(out[4].sum()) if self.end_to_end else None,
            launches=launches,
            serial_launches=serial_launches, peak_gib_per_card=peaks,
            results_equal=bool(equal))

    def tp_cost(self, genome) -> list:
        """walt_tpu's ``tp_cost``: the device program at tp = 1 against
        tp = 2 on one dp row, virtual on the first device and, with two
        or more cards, over two; and the legacy slab merge's time."""
        import torch

        from walt_tpu_torch.parallel import make_mesh
        from walt_tpu_torch.synth import sample_reads

        n = self.n
        codes, lens, _ = sample_reads(genome, n, READ_LEN, seed=5)
        prog = self.program(self.backend(), codes, lens, n)
        t1, _ = best_of(prog, self.reps, [self.device])
        rows = [dict(tp=1, virtual=False, device_program_s=t1)]
        layouts = [[self.device] * 2]
        if self.device.type == "cuda" and torch.cuda.device_count() >= 2:
            layouts.append([torch.device("cuda", i) for i in range(2)])
        for devices in layouts:
            backend = self.backend(make_mesh(devices, tp=2))
            try:
                prog = self.program(backend, codes, lens, n)
                t2, _ = best_of(prog, self.reps, devices)
            finally:
                backend.free_tables()
            merge_s = self.merge_s(devices) * len(self.tables)
            rows.append(dict(
                tp=2, virtual=devices[0] == devices[1], device_program_s=t2,
                implied_tp_efficiency=t1 / t2, legacy_slab_merge_s=merge_s,
                legacy_slab_merge_share=merge_s / t2))
        return rows

    def merge_s(self, devices) -> float:
        """Best seconds of one legacy slab merge over tp = len(devices)
        shards of (n, C) slabs: each shard's slab copied to the first
        device (the ``all_gather``), then ``merge_gathered``."""
        import numpy as np
        import torch

        from walt_tpu_torch.parallel import sharded

        n, C = self.n, self.single.cand_slab
        rng = np.random.default_rng(0)
        slabs = [(torch.from_numpy(rng.integers(-1, 3, (n, C)).astype(
                      np.int8)).to(d),
                  torch.from_numpy(rng.integers(0, 2**31, (n, C))).to(d),
                  torch.from_numpy(rng.integers(0, 7, (n, C)).astype(
                      np.int32)).to(d),
                  torch.zeros(n, dtype=torch.bool, device=d))
                 for d in devices]
        dst = devices[0]

        def merge():
            cs, cp, cm, fb = (sharded._gather([s[k] for s in slabs], dst)
                              for k in range(4))
            return sharded.merge_gathered(cs, cp, cm, fb.any(0), C,
                                          self.pattern.pattern_len)

        return best_of(merge, self.reps, devices)[0]


def peak_gib(devices) -> dict | None:
    """Peak allocated GiB per distinct card since the peaks were reset."""
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    return {str(d): cs.peak_gib([d]) for d in cards} or None


def measure(genome, tables, n: int, device, sizes=MESH_SIZES,
            reps: int = REPS, end_to_end: bool = True) -> list:
    """The report rows: one per mesh size in ``sizes``, then ``tp_cost``'s,
    each printed as it comes (measured numbers kept on a card only).
    ``end_to_end=False`` leaves out the end-to-end calls (``reads_per_s``,
    ``end_to_end_vs_1dev`` and ``fallback`` are None): a mesh's slab tiers
    take most of the tool's time."""
    sc = Scaling(tables, n, device, reps, end_to_end)
    rows = []

    def report(row):
        if device.type != "cuda":
            row = {k: None if k in MEASURED else v for k, v in row.items()}
        print(json.dumps(row), flush=True)
        rows.append(row)

    base = None
    for nd in sizes:
        row = sc.dp_row(genome, nd, base)
        base = base or row
        report(row)
    for row in sc.tp_cost(genome):
        report(row)
    return rows


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    on_card = args.device == "cuda"
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    index = args.index
    if index is None and on_card:
        index = cs.build_data(cs.DATA, cs.GENOME_BASES, cs.N_READS,
                              cs.N_PAIRS, cs.READ_LEN)[0]
    if index is None:
        from walt_tpu_torch.constants import get_pattern
        from walt_tpu_torch.index.build import build_table
        from walt_tpu_torch.synth import make_genome_repetitive

        genome = make_genome_repetitive(REHEARSAL_BASES, n_chroms=2, seed=3)
        tables = [build_table(genome, c, get_pattern("3"), verbose=False)
                  for c in ("CT00", "CT01")]
    else:
        genome, tables = index_genome(index), index_tables(index)
    reps = REPS if on_card else 1
    results = measure(genome, tables, args.n, device, reps=reps)
    report = {"n": args.n, "reps": reps, "results": results,
              "cards": torch.cuda.device_count() if on_card else 0,
              "card": cs.card_lines() if on_card else
              "cpu rehearsal: nothing measured"}
    if on_card:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr, flush=True)
    print(json.dumps(report), flush=True)
    if not all(r.get("results_equal", True) for r in results):
        print("a dp program's result differs from its serial chunks'",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
