"""PyTorch mapping backend, on one device or a (dp, tp) mesh.

Port of ``walt_tpu/core/jax_backend.py``: prepares device-resident tables
(packed genome words + an accelerating key structure), packs read batches
to 2-bit words on the host, tiles them into a short ladder of chunk
shapes, launches every chunk and then fetches the results, so
host-to-device copies and compute overlap.

For single-end mapping the whole BestMatch fold runs on the device
(``ops/se_fold``) and only (B, 3) results come back.  For paired-end
mapping each mate runs as one fused both-strand step (``ops/pe_map``) whose
flat candidate stream is decoded on the host into the per-strand slabs
``native.pe_finalize`` takes.  Reads whose candidates do not fit the fixed
shapes (or touch flagged buckets) are flagged for the exact host path --
output is identical either way.

With a mesh (``walt_tpu_torch.parallel``) every table is split over tp into
bucket ranges of about equal entry counts and every chunk over dp, and the
sharded steps replace the single-device ones; the device slab tiers then
run even with the native library (walt_tpu's mesh policy).

Each chunk's device step runs as a CUDA graph on the card (``ops/graphs``,
the counterpart of walt_tpu's ``jax.jit``): the backend's
:class:`~walt_tpu_torch.ops.graphs.StepCache` records it once per set of
static arguments and replays it for every chunk, and each result's copy to
the host starts right after its replay, before the next one overwrites it.
On a mesh each dp row replays its own graphs.  The cache is dropped with
the tables its graphs bake in.

Every tensor is created on the backend's explicit ``device``:
``process_single_end`` and ``process_paired_end`` call the backend from a
worker thread, and the current CUDA device is per thread.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from walt_tpu_torch import perf
from walt_tpu_torch.constants import SeedPattern
from walt_tpu_torch.core import refmap
from walt_tpu_torch.core.errors import HbmBudgetError
from walt_tpu_torch.genome import Genome
from walt_tpu_torch.index.build import HashTable
from walt_tpu_torch.ops import device_index, packing, pe_map, pipeline, se_fold
from walt_tpu_torch.ops.graphs import StepCache
from walt_tpu_torch.parallel import sharded


#: padded read length granularity: one packed 16-base word
LEN_PAD = 16

#: index-file suffix of each table, by (A/G wildcard reads, table strand);
#: the keys of :attr:`TorchBackend.rungs`
TABLE_NAMES = {(False, "+"): "CT00", (False, "-"): "CT01",
               (True, "+"): "GA10", (True, "-"): "GA11"}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def _oom_as_budget_error():
    """Raise a device out-of-memory error as HbmBudgetError, which
    process_single_end and process_paired_end answer by mapping the batch
    on the exact host path."""
    try:
        yield
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        raise HbmBudgetError(f"device out of memory: {e}") from e


class TorchBackend:
    name = "torch"

    #: bytes reserved for the mapping working set (read chunks, worklists,
    #: gather windows, table-build temporaries, the caching allocator's
    #: blocks, and the memory pools of the cached steps' CUDA graphs, which
    #: stay reserved while the graphs live) on top of the resident tables.
    #: ``chip_smoke.py`` measures the working set as the peak reserved
    #: device memory less the resident tables and what earlier work still
    #: holds, on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit, with
    #: the steps as graphs: 1.686 GiB for SE (1M reads; its pool 1.11 GiB),
    #: 2.216 GiB for PE (500k pairs), 3.712 GiB for SE and 3.464 GiB for PE
    #: on a dp=2 x tp=2 mesh virtual on one card (250k reads, 125k pairs:
    #: two row pools, 1.84-2.06 GiB, and the single-device backend's beside
    #: them).  Eager, the four were 0.818-1.022 GiB.  The reserve is 6 GiB,
    #: about 1.6x the largest: longer reads and more repeats widen the
    #: worklists, and each dp row on a card holds a pool.  A reserve too
    #: small shows as a device out-of-memory error, which maps the batch on
    #: the host.  The script fails when a working set exceeds the reserve.
    HBM_RESERVE = 6 << 30

    def __init__(self, device="cuda", chunk: int = 131072,
                 small_chunk: int = 2048,
                 verify_slab: int = pipeline.VERIFY_SLAB,
                 cand_slab: int = pipeline.CAND_SLAB,
                 verify_slab_t1: int = pipeline.VERIFY_SLAB_T1,
                 mesh=None, tp: int | None = None, tp_accel: str = "uniq"):
        """``chunk``: reads per device chunk.  ``verify_slab_t1``: the SE
        tier-1 verify slab (phases A and B, and the first pass of
        ``map_strand_slabs``).  The PE mate step's shapes are
        ``pe_map``'s constants (:attr:`pe_verify_slab`, :attr:`pe_wl`,
        :attr:`pe_flat_factor`).

        ``mesh``: a :class:`walt_tpu_torch.parallel.Mesh`, the string
        "auto" (every visible CUDA device when ``device`` is CUDA and there
        is more than one, split ``tp`` ways; else no mesh), or None (the one
        ``device``).  With a mesh, ``device`` is the mesh's first device.
        ``tp_accel``: the per-shard refinement structure, "uniq" or "key16"
        (the hg19-class memory rung)."""
        if mesh == "auto":
            mesh = None
            if torch.device(device).type == "cuda" and \
                    torch.cuda.is_available() and \
                    torch.cuda.device_count() > 1:
                mesh = sharded.make_mesh(tp=tp or 1)
        if mesh is not None:
            device = mesh.devices[0][0]
        if tp_accel not in ("uniq", "key16"):
            raise ValueError(f"TorchBackend: unknown tp_accel {tp_accel!r}")
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend: device 'cuda' requested but no CUDA "
                    "device is available")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        elif device.type != "cpu":
            raise ValueError(f"TorchBackend: unsupported device {device}")
        self.device = device
        self.mesh = mesh
        self.tp_accel = tp_accel
        self._dp = mesh.shape["dp"] if mesh is not None else 1
        self.chunk = chunk
        self.small_chunk = small_chunk
        self.verify_slab = verify_slab
        self.cand_slab = cand_slab
        self.verify_slab_t1 = verify_slab_t1
        #: the PE mate step's verify slab, worklist and flat slots per read
        self.pe_verify_slab = pe_map.VERIFY_SLAB
        self.pe_wl = pe_map.WL_FACTOR
        self.pe_flat_factor = pe_map.FLAT_FACTOR
        self._tables = {}
        #: table keys whose build already failed the memory budget; the
        #: failure is deterministic, so later batches short-circuit.  Values
        #: pin the (genome, table) objects so the id()-based key stays valid.
        self._failed_tables = {}
        #: how many tables the current run keeps resident (process_single_end
        #: sets 2, process_paired_end 4); the budget is split evenly across
        #: tables not yet built
        self.table_budget_hint = 0
        #: the key-structure rung each built table took ("uniq", "key16",
        #: "u32 word0" or "3-word"), by table name (:data:`TABLE_NAMES`),
        #: for reports
        self.rungs = {}
        #: the device steps' CUDA graphs (``ops/graphs``), on a mesh too
        self.graphs = StepCache()
        self.reset_adaptive()

    def reset_adaptive(self):
        """Reset the per-workload throughput heuristics (between files, so
        file N's phase schedule never depends on file N-1's reads)."""
        # measured fraction of reads whose best hit resolves at seed 0 with
        # 0 mismatches (the early exit, mapping.cpp:248-263); decides
        # whether a dedicated seed-0 phase pays for itself
        self._seed0_rate = None
        # tier-1 worklist slots per read (the JAX package's tuned value);
        # widened for workloads that spill
        self._wl1 = pipeline.WL1

    # ---- tables ----------------------------------------------------------
    def _device_table(self, genome: Genome, table: HashTable,
                      pattern: SeedPattern, n_key_words: int = 1,
                      wide_kw: bool = False, ag_wildcard: bool = False):
        """Cached resident table.  ``n_key_words``: packed key words the run
        needs (3 for -b below the verify slabs; an existing 1-word table is
        then rebuilt).  ``wide_kw``: prefer the u32 word-0 rung over key16
        when uniq does not fit (the PE paths: PE keeps every candidate
        <= -m, and key16's coarser run groups overflow its slab far more
        often); a key16 entry built without it is then rebuilt, so a PE run
        after an SE run in one process takes the wide rung and still holds
        one copy of each table.  ``ag_wildcard`` names the table in
        :attr:`rungs`.

        On a mesh the entry's tensors are the shard grid of
        ``sharded.shard_and_place``, on the ``tp_accel`` rung ("uniq" with
        3 key words when ``n_key_words`` asks for them); ``wide_kw`` does
        not apply."""
        # the entry holds strong references to (genome, table): the id()
        # key is only unambiguous while those objects are alive
        key = (id(genome), id(table), pattern.name)
        got = self._tables.get(key)
        if got is not None:
            kw_arr = (got[1][0][0] if self.mesh is not None
                      else got[1])["key_words"]
            stored = kw_arr.shape[-1] if kw_arr.dim() == 2 else 1
            key16_not_wide = (wide_kw and not got[4] and self.mesh is None
                              and kw_arr.dtype == torch.int16)
            if stored < n_key_words or key16_not_wide:
                # rebuild with deeper or wider key words; no graph may
                # outlive the tensors it bakes in
                self._drop_graphs(got[1])
                del self._tables[key]
        if key not in self._tables and self.mesh is not None:
            self._tables[key] = self._build_sharded_table(
                genome, table, pattern, n_key_words,
                TABLE_NAMES[ag_wildcard, genome.strand]) + (genome, table,
                                                            wide_kw)
        if key not in self._tables:
            if key in self._failed_tables:
                raise HbmBudgetError(
                    "table build already failed the memory budget this run"
                )
            try:
                dt, dev = self._build_single_device_table(
                    genome, table, pattern, n_key_words, wide_kw=wide_kw,
                    name=TABLE_NAMES[ag_wildcard, genome.strand],
                )
            except HbmBudgetError:
                self._failed_tables[key] = (genome, table)
                raise
            self._tables[key] = (dt, dev, genome, table, wide_kw)
        return self._tables[key][:2]

    def free_tables(self):
        """Drop every cached device table (and its memory) explicitly, and
        the cached steps, whose graphs bake in the tables' pointers."""
        self.graphs.clear()
        self._tables.clear()
        self._failed_tables.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _drop_graphs(self, placed) -> None:
        """Forget the cached steps that bake in ``placed``'s tensors (one
        table's dict, or its shard grid on a mesh)."""
        dicts = ([sh for row in placed for sh in row]
                 if self.mesh is not None else [placed])
        self.graphs.drop([v for d in dicts for v in d.values()
                          if torch.is_tensor(v)])

    def _build_sharded_table(self, genome: Genome, table: HashTable,
                             pattern: SeedPattern, n_key_words: int,
                             name: str):
        """(dt, shard grid) of one table on the mesh.  Runs whose -b is
        below the verify slabs need 3 key words and so the uniq accel;
        others take ``tp_accel``.  No memory budget: tp is how a table is
        made to fit (walt_tpu's mesh path has none either)."""
        need_full = n_key_words >= 3
        with perf.stage("setup.table_prep"):
            dt = device_index.build_device_table(genome, table, pattern)
        accel = "uniq" if need_full else self.tp_accel
        grid, dt.uniq_bits = sharded.shard_and_place(
            dt, self.mesh, pattern, accel=accel,
            n_key_words=3 if need_full else 0)
        self.rungs[name] = "3-word" if need_full else accel
        return dt, grid

    def _hbm_budget(self) -> int | None:
        """Device memory budget in bytes: ``WALTX_HBM_GB`` (GiB) when set,
        on any device; else the card's memory, or None (unconstrained) on
        the CPU."""
        env = os.environ.get("WALTX_HBM_GB")
        if env:
            return int(float(env) * (1 << 30))
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.mem_get_info(self.device)[1])

    @staticmethod
    def base_bytes(genome: Genome, table: HashTable) -> int:
        """Device bytes of a table without its key structure (packed genome
        words, counter, index, chromosome starts, bucket flags), from the
        raw table: what the memory ladder checks before its host prep."""
        nb1 = int(table.counter.shape[0])
        return (len(genome.seq) // 4 + 268 + 4 * nb1 + table.index.nbytes
                + genome.start_index.nbytes + (nb1 - 1))

    def table_bytes(self, device=None) -> int:
        """Bytes of the resident tables (on ``device``, when given): every
        distinct tensor storage of the cached tables, a mesh's shards and
        the genome words they share counted once per device."""
        seen = {}
        for entry in self._tables.values():
            dicts = ([sh for row in entry[1] for sh in row]
                     if self.mesh is not None else [entry[1]])
            for d in dicts:
                for v in d.values():
                    if torch.is_tensor(v) and device in (None, v.device):
                        st = v.untyped_storage()
                        seen[v.device, st.data_ptr()] = st.nbytes()
        return sum(seen.values())

    def _resident_bytes(self) -> int:
        return sum(_nbytes(v) for entry in self._tables.values()
                   for v in entry[1].values())

    def _build_single_device_table(self, genome: Genome, table: HashTable,
                                   pattern: SeedPattern, n_key_words: int,
                                   wide_kw: bool, name: str):
        """Place one table within the memory budget, degrading gracefully.

        Ladder: full table + uniq run index -> full table + one key-word
        rung (key16 or u32 word 0; 3 words for exact_b runs) ->
        HbmBudgetError (the batch is mapped on the exact host path).
        ``WALTX_KEY_RUNG`` (uniq|word0|key16) pins the ladder to one rung.
        """
        pipeline.check_entry_limit(
            int(table.index.shape[0]), "single-device table"
        )
        budget = self._hbm_budget()
        free = (None if budget is None
                else budget - self.HBM_RESERVE - self._resident_bytes())
        if free is not None and self.table_budget_hint:
            remaining = max(1, self.table_budget_hint - len(self._tables))
            free = free // remaining
        # the base footprint is computable from the raw table: check it
        # before the host prep so an over-budget table costs nothing
        base = self.base_bytes(genome, table)
        if free is not None and base > free:
            raise HbmBudgetError(
                f"table needs {base / 2**30:.2f} GB but only "
                f"{max(free, 0) / 2**30:.2f} GB of the "
                f"{budget / 2**30:.0f} GB device budget is free"
            )
        with perf.stage("setup.table_prep"):
            dt = device_index.build_device_table(genome, table, pattern)
        with perf.stage("setup.place"):
            base = (dt.pseq.nbytes + dt.counter.nbytes + dt.index.nbytes
                    + dt.start_index.nbytes + dt.bucket_flagged.nbytes)
            try:
                dev = device_index.place_table(dt, self.device)
            except torch.cuda.OutOfMemoryError as e:
                raise HbmBudgetError(f"table upload: {e}") from e
            n = int(dt.index.shape[0])
            uniq_max = (None if free is None
                        else free - base - dt.counter.nbytes)
            rung = os.environ.get("WALTX_KEY_RUNG", "")
            # skip the uniq build outright when even an optimistic run count
            # (U = 0.875n) cannot fit
            skip_uniq = ((uniq_max is not None and 7 * n > uniq_max)
                         or rung in ("word0", "key16"))
            uniq = None
            if not skip_uniq:
                try:
                    uniq = device_index.build_uniq_device(
                        dev["pseq"], dev["index"], dev["counter"], pattern,
                        max_bytes=uniq_max,
                    )
                except torch.cuda.OutOfMemoryError:
                    torch.cuda.empty_cache()
            uniq_bytes = 0
            label = "uniq"
            if uniq is not None:
                (dev["uniq_words"], dev["uniq_off"], dev["uniq_counter"],
                 dt.uniq_bits) = uniq
                uniq_bytes = sum(_nbytes(a) for a in uniq[:3])
            else:
                dt.uniq_bits = 0
                z = torch.zeros
                dev["uniq_words"] = z(1, dtype=torch.int32, device=self.device)
                dev["uniq_off"] = z(2, dtype=torch.int32, device=self.device)
                dev["uniq_counter"] = z(2, dtype=torch.int32,
                                        device=self.device)
            need_kw = max(n_key_words, 0 if dt.uniq_bits else 1)
            if need_kw >= 3 or (need_kw and not dt.uniq_bits):
                # One stored key word for a uniq-less fast-path table: the
                # full u32 word 0 (4 bytes/entry, refines to the exact word-0
                # run) or its 16-bit prefix (2 bytes/entry, coarser run
                # groups, more host fallback).  The JAX package measured
                # key16 + concurrent native host replay faster end to end on
                # its TPU, so key16 comes first when the native library is
                # present and the caller does not ask for the wide word; this
                # order is not yet measured on an NVIDIA card.
                from walt_tpu_torch import native as _native

                k16_first = _native.get_lib() is not None and not wide_kw
                kw_modes = ([(need_kw, 4 * need_kw * n, "3-word")]
                            if need_kw >= 3 else
                            [(0, 2 * n, "key16"), (1, 4 * n, "u32 word0")]
                            if k16_first else
                            [(1, 4 * n, "u32 word0"), (0, 2 * n, "key16")])
                if need_kw < 3 and rung == "word0":
                    kw_modes = [m for m in kw_modes if m[0] == 1]
                elif need_kw < 3 and rung == "key16":
                    kw_modes = [m for m in kw_modes if m[0] == 0]
                chosen = next(
                    (m for m in kw_modes
                     if free is None or base + uniq_bytes + m[1] <= free),
                    None)
                if chosen is None:
                    raise HbmBudgetError(
                        f"key words need {kw_modes[-1][1] / 2**30:.2f} GB on "
                        f"top of {(base + uniq_bytes) / 2**30:.2f} GB of "
                        f"tables; "
                        f"budget is {budget / 2**30:.0f} GB"
                    )
                mode, _, label = chosen

                def build_kw(m):
                    if m >= 1:
                        return device_index.build_key_words_device(
                            dev["pseq"], dev["index"], pattern, n_key_words=m)
                    return device_index.build_key16_device(
                        dev["pseq"], dev["index"], pattern)

                try:
                    dev["key_words"] = build_kw(mode)
                except torch.cuda.OutOfMemoryError as e:
                    # the budget passed but the real allocator did not:
                    # degrade to key16 once, after releasing the failed
                    # attempt's blocks
                    torch.cuda.empty_cache()
                    if mode < 1:
                        raise HbmBudgetError(f"key16 build: {e}") from e
                    try:
                        dev["key_words"] = build_kw(0)
                        label = "key16"
                    except torch.cuda.OutOfMemoryError as e2:
                        raise HbmBudgetError(
                            "key-word build exhausted device memory on every "
                            "rung; mapping on the exact host path") from e2
            else:
                dev["key_words"] = torch.zeros((1, 1), dtype=torch.int32,
                                               device=self.device)
            self.rungs[name] = label
        return dt, dev

    # ---- batching --------------------------------------------------------
    @staticmethod
    def _full_mask(lens_: np.ndarray, pattern: SeedPattern) -> bool:
        """True when every mappable read in the slice compares a full first
        packed key word (seed_len >= key_weight + 16)."""
        ok = lens_ >= pattern.min_read_len
        if not ok.any():
            return True
        sl = np.asarray(pattern.seed_len_for_len(lens_[ok]))
        return bool(sl.min() >= pattern.key_weight + 16)

    def _needed_key_words(self, b: int) -> int:
        """1 word when no tier can take the exact_b path, else all 3."""
        slabs = max(512, self.verify_slab, self.verify_slab_t1)
        return 1 if b >= slabs else 3

    def _chunks(self, codes: np.ndarray, lens: np.ndarray,
                pattern: SeedPattern, chunk: int | None = None):
        """Pack reads (the ``backend.pack`` span), then lazily yield
        fixed-shape (preads, lens) chunks on the device, from a short ladder
        of chunk shapes (small_chunk, x4 steps, chunk/2, chunk) so batch
        tails do not pay a full chunk; tiers with a large verify slab pass
        an explicit small ``chunk``.  On a mesh every chunk shape is a
        multiple of dp.  The bytes uploaded are counted under
        ``backend.h2d_bytes``."""
        n = codes.shape[0]
        Lmax = _round_up(max(int(codes.shape[1]), pattern.min_read_len),
                         LEN_PAD)
        W = Lmax // 16
        with perf.stage("backend.pack"):
            packed = packing.pack_codes_np(
                np.pad(codes, ((0, 0), (0, Lmax - codes.shape[1])))
            )
            # a read shorter than key_span hashes lanes past its end: base
            # code 0 there, as on the exact host paths (the batch pads with
            # PAD_CODE)
            short = np.flatnonzero(lens < pattern.key_span)
            if short.size:
                packed[short] = packing.clear_past_len_np(packed[short],
                                                          lens[short])
        ladder = [self.small_chunk]
        while ladder[-1] * 4 < self.chunk:
            ladder.append(ladder[-1] * 4)
        if self.chunk // 2 > ladder[-1]:
            ladder.append(self.chunk // 2)
        ladder.append(self.chunk)
        ladder = [_round_up(c, self._dp) for c in ladder]

        def upload():
            a = 0
            while a < n:
                c = _round_up(chunk, self._dp) if chunk is not None else next(
                    (s for s in ladder if n - a <= s), ladder[-1])
                z = min(a + c, n)
                pc = np.zeros((c, W), dtype=np.uint32)
                pc[: z - a] = packed[a:z]
                pl = np.zeros(c, dtype=np.int32)
                pl[: z - a] = lens[a:z]
                perf.count("backend.h2d_bytes", pc.nbytes + pl.nbytes)
                yield (a, z, packing.from_np(pc, self.device),
                       torch.from_numpy(pl).to(self.device))
                a = z

        return upload()

    @staticmethod
    def _to_host(tensors):
        """Start the device-to-host copies of ``tensors`` (pinned host
        memory on a card); do not wait.  Always copies: a step's outputs
        are its graph's, which the next replay overwrites (on the CPU too,
        where the step cache's stand-in aliases them the same way)."""
        return [t.to("cpu", non_blocking=True, copy=True) for t in tensors]

    def _wait(self, host):
        """One synchronize of every device in use, then the copies of
        :meth:`_to_host` as numpy.  Each device is named: the current device
        is per thread, and the drivers call from a worker thread."""
        devices = (self.mesh.distinct() if self.mesh is not None
                   else [self.device])
        with perf.stage("backend.sync"):
            for d in devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            return [h.numpy() for h in host]

    # ---- device steps: graph replays on the card (ops/graphs) ----------
    def se_step(self, preads, lens, b: int, max_mm: int, tables, **kw):
        """One chunk's SE step: ``se_fold.map_single_end_device`` (keyword
        arguments as there), or ``sharded.map_single_end_sharded`` on a
        mesh, through :attr:`graphs`.  On one device the result is the
        graph's own tensor: copy it out before the next step."""
        if self.mesh is not None:
            return sharded.map_single_end_sharded(
                preads, lens, b, max_mm, tables, mesh=self.mesh,
                graphs=self.graphs, **kw)
        return self.graphs.run(se_fold.map_single_end_device, (preads, lens),
                               b, max_mm, tables, **kw)

    def mate_step(self, preads, lens, b: int, max_mm: int, tables, **kw):
        """One chunk's PE mate step: ``pe_map.map_mate_device``, or
        ``sharded.map_mate_sharded`` on a mesh (as :meth:`se_step`)."""
        if self.mesh is not None:
            return sharded.map_mate_sharded(
                preads, lens, b, max_mm, tables, mesh=self.mesh,
                graphs=self.graphs, **kw)
        return self.graphs.run(pe_map.map_mate_device, (preads, lens), b,
                               max_mm, tables, **kw)

    def strand_step(self, preads, lens, b: int, max_mm: int, table, **kw):
        """One chunk's strand pass against one placed table:
        ``pipeline.map_strand_core``, or ``sharded.map_strand_sharded`` on
        a mesh (as :meth:`se_step`)."""
        if self.mesh is not None:
            return sharded.map_strand_sharded(
                preads, lens, b, max_mm, table, mesh=self.mesh,
                graphs=self.graphs, **kw)
        return self.graphs.run(
            pipeline.map_strand_core, (preads, lens), b, max_mm,
            table["pseq"], table["counter"], table["index"],
            table["key_words"], table["start_index"],
            table["bucket_flagged"], uniq_words=table["uniq_words"],
            uniq_off=table["uniq_off"], uniq_counter=table["uniq_counter"],
            **kw)

    # ---- single-end ------------------------------------------------------
    def map_single_end(self, codes: np.ndarray, lens: np.ndarray, tables,
                       b: int, max_mismatches: int, pattern: SeedPattern,
                       ag_wildcard: bool = False):
        """Full SE step on the device for both strand tables ('+' then '-').

        ``tables``: [(genome, hash_table), (genome, hash_table)].
        Returns (pos (n,) uint32, times (n,) int32, minus (n,) bool,
        mismatch (n,) int32, fallback (n,) bool).  A device out-of-memory
        error is raised as HbmBudgetError, which process_single_end answers by
        mapping the batch on the exact host path.
        """
        with _oom_as_budget_error():
            return self._map_single_end(codes, lens, tables, b,
                                        max_mismatches, pattern, ag_wildcard)

    def _map_single_end(self, codes, lens, tables, b, max_mismatches,
                        pattern, ag_wildcard):
        n = codes.shape[0]
        devs, bits, ubits = [], [], []
        nkw = self._needed_key_words(b)
        for g, ht in tables:
            dt, dev = self._device_table(g, ht, pattern, nkw,
                                         ag_wildcard=ag_wildcard)
            devs.append(dev)
            bits.append(dt.max_bucket_bits)
            ubits.append(dt.uniq_bits)

        def run(codes_, lens_, seeds, slab, cand_slab=None, chunk=None,
                wl_factor=pipeline.WL_FACTOR):
            m = codes_.shape[0]
            spans, results = [], []
            chunks = self._chunks(codes_, lens_, pattern, chunk)
            with perf.stage("backend.launch"):
                for a, z, pc, pl in chunks:
                    results.extend(self._to_host([self.se_step(
                        pc, pl, b, max_mismatches, tuple(devs),
                        pattern_name=pattern.name, ag_wildcard=ag_wildcard,
                        search_bits=tuple(bits), verify_slab=slab,
                        cand_slab=cand_slab or self.cand_slab, seeds=seeds,
                        wl_factor=wl_factor, exact_b=b < slab,
                        uniq_bits=tuple(ubits),
                        full_mask=self._full_mask(lens_[a:z], pattern),
                    )]))
                    spans.append((a, z))
            out = [np.empty(m, t) for t in
                   (np.uint32, np.int32, bool, np.int32, bool)]
            host = self._wait(results)
            with perf.stage("backend.decode"):
                for (a, z), r in zip(spans, host):
                    for o, x in zip(out,
                                    se_fold.unpack_se_result(r[: z - a])):
                        o[a:z] = x
            return out

        def merge(into, idx, vals):
            for o, v in zip(into, vals):
                o[idx] = v

        # Phase A: seed 0 only, both strands.  A read whose best hit has 0
        # mismatches is FINAL here: the early-exit gate (mapping.cpp:248-263)
        # skips seeds 1..2 on both strand passes.  Whether the phase pays
        # depends on the workload's error profile, so the observed resolve
        # rate decides.
        if self._seed0_rate is None or self._seed0_rate >= 0.5:
            out = run(codes, lens, (0,), self.verify_slab_t1,
                      wl_factor=self._wl1)
            pos, times, minus, mm, fb = out
            resolved = (mm == 0) & ~fb
            rate = float(resolved.mean()) if n else 1.0
            self._seed0_rate = rate if self._seed0_rate is None else (
                0.5 * self._seed0_rate + 0.5 * rate
            )
            # Phase B: the full seed schedule for unresolved reads
            todo = np.flatnonzero(~resolved)
            if todo.size:
                merge(out, todo,
                      run(codes[todo], lens[todo], None,
                          self.verify_slab_t1, wl_factor=self._wl1))
        else:
            out = run(codes, lens, None, self.verify_slab_t1,
                      wl_factor=self._wl1)
            pos, times, minus, mm, fb = out
        if self._wl1 < pipeline.WL_FACTOR and n and fb.mean() > 0.05:
            # dense-candidate workload: widen future batches' worklists
            self._wl1 = pipeline.WL_FACTOR
        # With the native exact enumerator every overflow read on ONE device
        # goes to the host replay, which process_single_end runs
        # concurrently with the next batch's device work (the JAX package's
        # single-device policy).  On a mesh the device tiers below run even
        # with the native library (walt_tpu's mesh policy): a tp mesh on the
        # key16 rung, the hg19 deployment, overflows tier 1 on most reads,
        # and replaying most of a workload on one host would leave the
        # devices idle.
        from walt_tpu_torch import native as _native

        if _native.get_lib() is None or self.mesh is not None:
            # Tier 2: larger verify slab for reads that overflowed tier 1;
            # Tier 3: highly repetitive reads (runs up to 512); Tier 4: the
            # deep-repeat tail (key16 run groups up to 4096).  Small chunks
            # keep the padded worklists bounded.
            for slab, cand, chunk in ((self.verify_slab, None, 8192),
                                      (512, 512, 256), (4096, 512, 64)):
                todo = np.flatnonzero(out[4])
                if todo.size <= max(256, n // 128):
                    break
                merge(out, todo,
                      run(codes[todo], lens[todo], None, slab,
                          cand_slab=cand, chunk=chunk, wl_factor=3 * slab))
        perf.count("backend.reads", n)
        perf.count("backend.fallback_reads", int(out[4].sum()))
        return out

    # ---- paired-end mate step ----------------------------------------------
    def map_mate_slabs_begin(self, codes: np.ndarray, lens: np.ndarray,
                             tables, ag_wildcard: bool, b: int,
                             max_mismatches: int, pattern: SeedPattern):
        """Launch one mate's fused both-strand step over every chunk and
        start the copies of its flat results to the host; do not wait.

        Returns a handle for :meth:`map_mate_slabs_finish`:
        process_paired_end launches both mates before it waits for either.
        A device out-of-memory error is raised as HbmBudgetError.
        """
        with _oom_as_budget_error():
            chunks = self._chunks(codes, lens, pattern)
            with perf.stage("backend.launch"):
                devs, bits, ubits = [], [], []
                nkw = self._needed_key_words(b)
                for g, ht in tables:
                    dt, dev = self._device_table(g, ht, pattern, nkw,
                                                 wide_kw=True,
                                                 ag_wildcard=ag_wildcard)
                    devs.append(dev)
                    bits.append(dt.max_bucket_bits)
                    ubits.append(dt.uniq_bits)
                slab = self.pe_verify_slab
                spans, results = [], []
                for a, z, pc, pl in chunks:
                    results.extend(self._to_host(self.mate_step(
                        pc, pl, b, max_mismatches, tuple(devs),
                        pattern_name=pattern.name, ag_wildcard=ag_wildcard,
                        search_bits=tuple(bits), verify_slab=slab,
                        cand_slab=self.cand_slab,
                        wl_factor=self.pe_wl, exact_b=b < slab,
                        flat_factor=self.pe_flat_factor,
                        uniq_bits=tuple(ubits),
                        full_mask=self._full_mask(lens[a:z], pattern),
                    )))
                    spans.append((a, z))
            return codes.shape[0], spans, results

    def map_mate_slabs_finish(self, handle):
        """Wait for a :meth:`map_mate_slabs_begin` handle (one synchronize)
        and decode its flat streams.

        Reads that overflowed a slab or spilled the flat stream are flagged
        and go to the native host replay, which process_paired_end runs
        concurrently with the next batch's device work (the JAX package's
        policy, on a mesh too; see ``PERF.md`` section 7).
        """
        n, spans, host = handle
        with _oom_as_budget_error():
            host = self._wait(host)
        with perf.stage("backend.decode"):
            streams, fallback = self._decode_mate(spans, host, n)
        perf.count("backend.reads", n)
        perf.count("backend.fallback_reads", int(fallback.sum()))
        return streams, fallback

    def _decode_mate(self, spans, host, n: int):
        """Flat (meta, flat) chunk results -> per-strand slab streams.

        ``host``: per chunk of ``spans``, meta (B,) and flat (M, 2) from one
        device, or meta (T, B) and flat (T, dp*M_l, 2) from a mesh: one
        stream per tp shard, each in dp segments of B/dp reads and M_l rows.
        A (read, seed) bucket lives on one shard, so with T > 1 the shards'
        entries are interleaved back into examination order (seed asc, then
        shard and stream order) by one lexsort.  Returns ([dict(seed, pos,
        mm, cnt)] for strand '+' then '-', fallback (n,) bool); slabs are
        (n, cand_slab), C-contiguous, as ``native.pe_finalize`` takes them.
        A read with more than cand_slab merged entries on a strand falls
        back.

        With T > 1 the decode counts, per shard t, the flat entries decoded
        from its stream (``mesh.flat_rows.<t>``) and the mates whose
        fallback bit it set (``mesh.fallback_reads.<t>``), and the mates
        that fall back only because their shards' merged entries overflow
        the slab (``mesh.merged_overflow_reads``); the merge is the span
        ``backend.decode.merge``.  One shard counts none.
        """
        C = self.cand_slab
        streams = [dict(seed=np.zeros((n, C), dtype=np.int8),
                        pos=np.zeros((n, C), dtype=np.uint32),
                        mm=np.zeros((n, C), dtype=np.int32),
                        cnt=np.zeros(n, dtype=np.int32))
                   for _ in range(2)]
        fallback = np.zeros(n, dtype=bool)
        cnt_acc = np.zeros((2, n), dtype=np.int64)
        pend = []  # entries of several shards, awaiting the seed-order merge
        shard_rows, shard_fb = {}, {}  # per shard t, when T > 1
        for i, (a, z) in enumerate(spans):
            metas, flats = host[2 * i], host[2 * i + 1].view(np.uint32)
            if metas.ndim == 1:
                metas, flats = metas[None], flats[None]
            T = metas.shape[0]
            seg_reads = metas.shape[1] // self._dp
            seg_m = flats.shape[1] // self._dp
            for t in range(T):
                for g in range(self._dp):
                    a0 = a + g * seg_reads
                    if a0 >= z:
                        break
                    z0 = min(a0 + seg_reads, z)
                    meta = metas[t, g * seg_reads:][: z0 - a0].astype(np.int64)
                    flat = flats[t, g * seg_m:(g + 1) * seg_m]
                    cnt0 = meta & 0xFF
                    cnt1 = (meta >> 8) & 0xFF
                    fb = ((meta >> 16) & 1).astype(bool)
                    fallback[a0:z0] |= fb
                    cnt_acc[0, a0:z0] += cnt0
                    cnt_acc[1, a0:z0] += cnt1
                    total = cnt0 + cnt1
                    m = int(total.sum())  # <= M_l: spilled reads count none
                    if T > 1:
                        shard_rows[t] = shard_rows.get(t, 0) + m
                        shard_fb[t] = shard_fb.get(t, 0) + int(fb.sum())
                    if not m:
                        continue
                    rid = np.repeat(np.arange(z0 - a0), total)
                    within = np.arange(m) - (np.cumsum(total) - total)[rid]
                    w1 = flat[:m, 1]
                    strand = (w1 >> 1) & 1
                    entry = (rid + a0, strand, (w1 >> 2) & 0x3F, flat[:m, 0],
                             w1 >> 8,
                             np.where(strand == 0, within, within - cnt0[rid]))
                    if T == 1:
                        self._put(streams, *entry)
                    else:
                        pend.append(entry + (np.full(m, t),))
        if pend:
            with perf.stage("backend.decode.merge"):
                rid, strand, seed, pos, mm, col, shard = (
                    np.concatenate([p[k] for p in pend]) for k in range(7))
                # examination order: seed asc (one shard per (read, seed)),
                # then the shard's stream order
                order = np.lexsort((col, shard, seed, strand, rid))
                rid, strand, seed, pos, mm = (
                    x[order] for x in (rid, strand, seed, pos, mm))
                start = np.ones(rid.shape[0], dtype=bool)
                start[1:] = ((rid[1:] != rid[:-1])
                             | (strand[1:] != strand[:-1]))
                col = np.arange(rid.shape[0]) - np.maximum.accumulate(
                    np.where(start, np.arange(rid.shape[0]), 0))
                ok = col < C  # reads past the slab fall back through cnt_acc
                self._put(streams, rid[ok], strand[ok], seed[ok], pos[ok],
                          mm[ok], col[ok])
        for s, st in enumerate(streams):
            st["cnt"][:] = np.minimum(cnt_acc[s], C)
        over = (cnt_acc > C).any(0)
        for t, rows in shard_rows.items():
            perf.count(f"mesh.flat_rows.{t}", rows)
            perf.count(f"mesh.fallback_reads.{t}", shard_fb[t])
        if shard_rows:
            perf.count("mesh.merged_overflow_reads",
                       int((over & ~fallback).sum()))
        fallback |= over
        return streams, fallback

    @staticmethod
    def _put(streams, rid, strand, seed, pos, mm, col):
        """Write decoded flat entries into the per-strand slabs."""
        for s, st in enumerate(streams):
            sel = strand == s
            r, c = rid[sel], col[sel]
            st["seed"][r, c] = seed[sel].astype(np.int8)
            st["pos"][r, c] = pos[sel]
            st["mm"][r, c] = mm[sel].astype(np.int32)

    def map_mate_slabs(self, codes: np.ndarray, lens: np.ndarray, tables,
                       ag_wildcard: bool, b: int, max_mismatches: int,
                       pattern: SeedPattern):
        """One mate against both strand tables, fused (``ops/pe_map``).

        ``tables``: [(genome, hash_table), (genome, hash_table)], '+' first.
        Returns ([dict(seed, pos, mm, cnt)] per strand, fallback (n,) bool).
        Flagged reads (slab overflow or flat spill) carry no usable slab
        entries; process_paired_end maps them on the exact host path.
        """
        return self.map_mate_slabs_finish(self.map_mate_slabs_begin(
            codes, lens, tables, ag_wildcard, b, max_mismatches, pattern))

    # ---- per-strand candidate streams --------------------------------------
    def map_strand_slabs(self, codes: np.ndarray, lens: np.ndarray,
                         genome: Genome, table: HashTable, ag_wildcard: bool,
                         b: int, max_mismatches: int, pattern: SeedPattern):
        """Candidate slabs for a batch against one table, slab-tiered.

        Returns (cand_seed (n,C) int8, cand_pos (n,C) uint32,
        cand_mm (n,C) int32, cand_cnt (n,) int32, fallback (n,) bool).  A
        device out-of-memory error is raised as HbmBudgetError.
        """
        with _oom_as_budget_error():
            return self._map_strand_slabs(codes, lens, genome, table,
                                          ag_wildcard, b, max_mismatches,
                                          pattern)

    def _map_strand_slabs(self, codes, lens, genome, table, ag_wildcard, b,
                          max_mismatches, pattern):
        n = codes.shape[0]
        dt, dev = self._device_table(genome, table, pattern,
                                     self._needed_key_words(b), wide_kw=True,
                                     ag_wildcard=ag_wildcard)
        C = self.cand_slab

        def run(codes_, lens_, slab, chunk=None,
                wl_factor=pipeline.WL_FACTOR):
            m = codes_.shape[0]
            spans, results = [], []
            chunks = self._chunks(codes_, lens_, pattern, chunk)
            with perf.stage("backend.launch"):
                for a, z, pc, pl in chunks:
                    kw = dict(pattern_name=pattern.name,
                              ag_wildcard=ag_wildcard,
                              search_bits=dt.max_bucket_bits,
                              verify_slab=slab, cand_slab=C,
                              wl_factor=wl_factor, exact_b=b < slab,
                              uniq_bits=dt.uniq_bits,
                              full_mask=self._full_mask(lens_[a:z], pattern))
                    results.extend(self._to_host(self.strand_step(
                        pc, pl, b, max_mismatches, dev, **kw)))
                    spans.append((a, z))
            out = (
                np.empty((m, C), dtype=np.int8),
                np.empty((m, C), dtype=np.uint32),
                np.empty((m, C), dtype=np.int32),
                np.empty(m, dtype=np.int32),
                np.empty(m, dtype=bool),
            )
            host = self._wait(results)
            for i, (a, z) in enumerate(spans):
                for o, x in zip(out, host[5 * i: 5 * i + 5]):
                    o[a:z] = x[: z - a]
            return out

        out = run(codes, lens, self.verify_slab_t1)
        # chunks bounded so the tier worklists (wl_factor x chunk rows)
        # stay small
        for slab, chunk in ((self.verify_slab, 8192), (512, 256)):
            todo = np.flatnonzero(out[4])
            if not todo.size:
                break
            vals = run(codes[todo], lens[todo], slab, chunk,
                       wl_factor=3 * slab)
            for o, v in zip(out, vals):
                o[todo] = v
        perf.count("backend.reads", n)
        perf.count("backend.fallback_reads", int(out[4].sum()))
        return out

    def map_strand(self, codes: np.ndarray, lens: np.ndarray, genome: Genome,
                   table: HashTable, ag_wildcard: bool, b: int,
                   max_mismatches: int, pattern: SeedPattern) -> list:
        """Per-read ordered candidate lists (exact; slabs + host fallback)."""
        n = codes.shape[0]
        if n == 0:
            return []
        cand_seed, cand_pos, cand_mm, cand_cnt, fallback = self.map_strand_slabs(
            codes, lens, genome, table, ag_wildcard, b, max_mismatches, pattern
        )
        out = []
        seq_padded = None
        for i in range(n):
            if fallback[i]:
                if seq_padded is None:
                    seq_padded = refmap.padded_seq(genome, pattern)
                out.append(list(refmap.enumerate_candidates(
                    codes[i, : int(lens[i])], genome, table, ag_wildcard, b,
                    max_mismatches, pattern, seq_padded=seq_padded,
                )))
            else:
                c = int(cand_cnt[i])
                out.append(list(zip(
                    cand_seed[i, :c].tolist(),
                    cand_pos[i, :c].tolist(),
                    cand_mm[i, :c].tolist(),
                )))
        return out
