"""Sharded mapping: reads over ``dp``, the hash table over ``tp``.

Port of ``walt_tpu/parallel/sharded.py``.  Table sharding is by contiguous
bucket-key range: shard ``s`` of ``T`` owns buckets ``[k_s, k_{s+1})`` with
a localized CSR (counter rebased to the shard's first entry).  A bucket
lives wholly on one shard, so for a given (read, seed) at most one shard
produces candidates, and the pipeline's ``tp_route`` mode compacts each
shard's owned (read, seed) pairs before the search.

The routed capacity and the worklist of a shard's pass are sized for 1/T
of the (read, seed) pairs, so the port cuts each table where its own CSR
counter reaches each multiple of N/T entries (:func:`balanced_bounds`).
walt_tpu cuts T equal key ranges (``k_s = s*nb/T``,
:func:`bucket_range_bounds`), but the top key bits are a position's first
cared base: at tp=4 a human C->T table has about half its entries on the
T range and almost none on the C range, and the heavy shard's owned pairs
overflow its routed capacity, which sends a suffix of every chunk to the
host.  Either split is bucket-granular, so the merges and the host decode
are the same.

walt_tpu runs one ``shard_map`` program over a JAX mesh: one dispatch runs
every shard on every chip at once.  Here a :class:`Mesh` is a (dp, tp)
grid of torch devices.  Its dp rows run at once, each on a host thread of
the mesh's own pool (:meth:`Mesh.run_rows`; one thread per row, made at
first use; a dp=1 mesh runs its row on the calling thread), with the row's
first device as the thread's current CUDA device.  Each single-device part
of a row is a CUDA graph of the caller's step cache (``ops/graphs``; the
row is its lane, so rows never share a graph or a pool): each tp shard's
strand pass (with its ``segment_summaries`` for SE, both tables and the
flat compaction for PE), then the row's merge or fold on its first
device.  A replay gives up the interpreter lock once, where the eager pass
handed it to the other rows' threads at each of its ~1,000 ops.  Within a
row the tp shard steps run one after another, each on its own device (their
launches are asynchronous, so shards on different cards overlap).  A
device may appear more than once in the grid: a virtual mesh puts several
shards on one card, as walt_tpu's tests put them on virtual CPU devices,
and rows that share a card launch onto its one stream, which keeps their
work in order.  walt_tpu's ``all_gather`` over tp is a copy of each
shard's outputs to the first device of its dp row (a copy on one card
too: the next replay overwrites a graph's outputs), then a stack.  The
caller joins the rows in row order and concatenates their results on the
mesh's first device.  Results, fallback bits and kernel launches are those
of running the rows one after another.

Placed shard tensors are exact-size (``shard_map``'s uniform shapes, and
walt_tpu's padded ``(T, max_len)`` stacks, have no counterpart in torch);
each (shard, distinct device) is placed once and shared by the dp rows on
that device, and the packed genome and chromosome starts are placed once
per distinct device.  :func:`shard_device_table` keeps walt_tpu's padded
host layout (bit for bit at walt_tpu's equal ranges).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading

import numpy as np
import torch

from walt_tpu_torch import perf
from walt_tpu_torch.constants import SeedPattern, get_pattern
from walt_tpu_torch.ops import device_index, packing, pe_map, pipeline, se_fold
from walt_tpu_torch.ops.device_index import DeviceTable
from walt_tpu_torch.ops.graphs import StepCache


class Mesh:
    """A (dp, tp) grid of torch devices.

    ``devices``: dp rows of tp devices each.  A device may appear more than
    once (a virtual mesh).  ``shape["dp"]`` and ``shape["tp"]`` give the
    grid's size, as on a JAX mesh.
    """

    def __init__(self, devices):
        rows = [[self._device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("Mesh: devices must be a non-empty (dp, tp) grid")
        self.devices = rows
        self.shape = {"dp": len(rows), "tp": len(rows[0])}
        self._pool = None  # dp row threads, made by the first run_rows
        self._pool_lock = threading.Lock()

    def run_rows(self, row):
        """``[row(d) for d in range(dp)]``, the rows run at once.

        With dp > 1 each row runs on a thread of the mesh's pool (dp
        threads), which first makes the row's first device its current
        CUDA device.  Every row finishes before this returns or raises; a
        row's exception is raised here with its type (the first failed
        row's, in row order)."""
        dp = self.shape["dp"]
        if dp == 1:
            return [row(0)]
        with self._pool_lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    dp, thread_name_prefix="mesh-dp")
        futures = [self._pool.submit(self._on_row_device, row, d)
                   for d in range(dp)]
        concurrent.futures.wait(futures)
        return [f.result() for f in futures]

    def _on_row_device(self, row, d: int):
        first = self.devices[d][0]
        if first.type == "cuda":
            torch.cuda.set_device(first)
        return row(d)

    @staticmethod
    def _device(d) -> torch.device:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        return d

    def distinct(self) -> list:
        """The distinct devices of the grid, in row-major order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def __repr__(self):
        return f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, " \
               f"devices={self.distinct()})"


def make_mesh(devices=None, tp: int | None = None) -> Mesh:
    """A (dp, tp) mesh over ``devices`` (default: every visible CUDA
    device, else the CPU), tp-major within a dp row.  ``tp`` defaults to 2
    on an even device count above 1, else 1."""
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    devices = list(devices)
    n = len(devices)
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if n == 0 or n % tp:
        raise ValueError(f"make_mesh: {n} devices do not split into tp={tp}")
    return Mesh([devices[i * tp:(i + 1) * tp] for i in range(n // tp)])


@dataclasses.dataclass
class ShardedTables:
    """Per-shard stacked host tables (leading axis = tp shards), padded to
    the largest shard as in walt_tpu."""

    key_base: np.ndarray  # uint32 (T,) first bucket of each shard
    # uint32 (T, max_nbl + 1) localized CSR offsets, max_nbl the most
    # buckets of a shard; a shorter shard's tail repeats its entry count
    counter: np.ndarray
    index: np.ndarray  # uint32 (T, max_len) padded position slices
    key_words: np.ndarray  # uint32 (T, max_len, nw), or uint16 (T, max_len)
    bucket_flagged: np.ndarray  # uint8 bit mask (T, max_nbl), tail 0
    pseq: np.ndarray  # uint32, replicated packed converted genome words
    start_index: np.ndarray  # uint32, replicated
    max_bucket_bits: int
    # word-0 run dedup, localized per shard: counter over runs, run key
    # words, run start entry offsets
    uniq_counter: np.ndarray  # uint32 (T, max_nbl + 1), tail as counter
    uniq_words: np.ndarray  # uint32 (T, max_ulen)
    uniq_off: np.ndarray  # uint32 (T, max_ulen + 1)
    uniq_bits: int


def bucket_range_bounds(counter: np.ndarray, n_shards: int):
    """walt_tpu's split of a CSR ``counter`` into ``n_shards`` equal
    bucket-key ranges: (bucket bounds, entry bounds), each (T + 1,) int64;
    raises when the buckets do not divide."""
    nb = counter.shape[0] - 1
    if nb % n_shards:
        raise ValueError(f"{nb} buckets not divisible by {n_shards} shards")
    kb = np.arange(n_shards + 1, dtype=np.int64) * (nb // n_shards)
    return kb, counter[kb].astype(np.int64)


def balanced_bounds(counter: np.ndarray, n_shards: int):
    """The runtime's split of a CSR ``counter`` into ``n_shards`` bucket
    ranges of about equal entry counts: (bucket bounds, entry bounds), each
    (T + 1,) int64.

    Cut t falls on the bucket boundary nearest t*N/T entries; cuts are then
    moved apart so that every shard holds at least one bucket.  A shard
    holds at most ceil(N/T) + the largest bucket's entries."""
    nb = counter.shape[0] - 1
    if nb < n_shards:
        raise ValueError(f"{nb} buckets do not split into {n_shards} shards")
    target = (np.arange(1, n_shards, dtype=np.int64) * int(counter[-1])
              // n_shards)
    hi = np.clip(np.searchsorted(counter, target.astype(counter.dtype)),
                 1, nb)
    below = target - counter[hi - 1].astype(np.int64)
    above = counter[hi].astype(np.int64) - target
    kb = np.concatenate([[0], np.where(below < above, hi - 1, hi), [nb]])
    for t in range(1, n_shards):  # strictly increasing ...
        kb[t] = max(kb[t], kb[t - 1] + 1)
    for t in range(n_shards - 1, 0, -1):  # ... and below nb
        kb[t] = min(kb[t], kb[t + 1] - 1)
    return kb, counter[kb].astype(np.int64)


def _shard_bounds(counter: np.ndarray, n_shards: int, where: str):
    """(bucket bounds, entry bounds) of a table's tp split
    (:func:`balanced_bounds`); raises when a shard would overflow the
    pipeline's int32 entry indices."""
    kb, bounds = balanced_bounds(counter, n_shards)
    pipeline.check_entry_limit(int(np.diff(bounds).max()), where)
    return kb, bounds


def shard_device_table(dt: DeviceTable, n_shards: int,
                       accel: str = "uniq", free_input: bool = False
                       ) -> ShardedTables:
    """Split one host DeviceTable into ``n_shards`` bucket-range shards.

    walt_tpu's padded host layout: the per-entry arrays padded to the
    largest shard, the per-bucket arrays to the shard of most buckets
    (bit for bit walt_tpu's tables when the split is walt_tpu's equal
    ranges, :func:`bucket_range_bounds`).  ``accel``: "uniq" (word-0 run
    index + the stored key words) or "key16" (16-bit prefix keys and no
    uniq runs; needs word 0 in ``dt.key_words``).  ``free_input`` drops
    ``dt.key_words`` once the key16 prefixes are derived from it.
    """
    if dt.key_words is None:
        raise ValueError(
            "shard_device_table needs host key_words; build the table with "
            "build_device_table(..., with_key_words=True or 'word0')"
        )
    if accel not in ("uniq", "key16"):
        raise ValueError(f"unknown accel {accel!r}")
    kb, bounds = _shard_bounds(dt.counter, n_shards,
                               f"shard_device_table(tp={n_shards})")
    max_len = max(1, int(np.diff(bounds).max()))
    max_nbl = int(np.diff(kb).max())

    counter = np.zeros((n_shards, max_nbl + 1), dtype=np.uint32)
    index = np.zeros((n_shards, max_len), dtype=np.uint32)
    nw = dt.key_words.shape[1]
    if accel == "key16":
        key16_full = (dt.key_words[:, 0] >> np.uint32(16)).astype(np.uint16)
        if free_input:
            dt.key_words = None
        key_words = np.zeros((n_shards, max_len), dtype=np.uint16)
    else:
        key_words = np.zeros((n_shards, max_len, nw), dtype=np.uint32)
    # uint8 bit masks, as in the unsharded table (walt_tpu casts them to
    # bool, which loses the exact_b bit)
    flagged = np.zeros((n_shards, max_nbl), dtype=np.uint8)

    if accel == "uniq":
        g_uw, g_uo, g_uc, uniq_bits = device_index.build_uniq_host(
            dt.key_words[:, 0], dt.counter)
        u_bounds = g_uc[kb].astype(np.int64)
        max_ulen = max(1, int(np.diff(u_bounds).max()))
    else:
        max_ulen, uniq_bits = 1, 0
    uniq_counter = np.zeros((n_shards, max_nbl + 1), dtype=np.uint32)
    uniq_words = np.zeros((n_shards, max_ulen), dtype=np.uint32)
    uniq_off = np.zeros((n_shards, max_ulen + 1), dtype=np.uint32)
    for s in range(n_shards):
        a, b = int(bounds[s]), int(bounds[s + 1])
        k0, k1 = int(kb[s]), int(kb[s + 1])
        counter[s, : k1 - k0 + 1] = dt.counter[k0:k1 + 1] - dt.counter[k0]
        counter[s, k1 - k0 + 1:] = b - a
        index[s, : b - a] = dt.index[a:b]
        key_words[s, : b - a] = (key16_full[a:b] if accel == "key16"
                                 else dt.key_words[a:b])
        flagged[s, : k1 - k0] = dt.bucket_flagged[k0:k1]
        if accel != "uniq":
            continue
        au, bu = int(u_bounds[s]), int(u_bounds[s + 1])
        uniq_counter[s, : k1 - k0 + 1] = g_uc[k0:k1 + 1] - np.uint32(au)
        uniq_counter[s, k1 - k0 + 1:] = bu - au
        uniq_words[s, : bu - au] = g_uw[au:bu]
        # run starts rebased to the shard's first entry; g_uo[bu] is the
        # next shard's first entry == this shard's entry count
        uniq_off[s, : bu - au + 1] = g_uo[au:bu + 1] - np.uint32(a)
    return ShardedTables(
        key_base=kb[:-1].astype(np.uint32),
        counter=counter, index=index, key_words=key_words,
        bucket_flagged=flagged, pseq=dt.pseq, start_index=dt.start_index,
        max_bucket_bits=dt.max_bucket_bits, uniq_counter=uniq_counter,
        uniq_words=uniq_words, uniq_off=uniq_off, uniq_bits=uniq_bits,
    )


def _at_least_one(t: torch.Tensor) -> torch.Tensor:
    """A 1-D tensor, or one zero when it is empty: the pipeline's clamped
    gathers need an element to clamp to (the slot is never used)."""
    return t if t.shape[0] else torch.zeros(1, dtype=t.dtype, device=t.device)


def shard_and_place(dt: DeviceTable, mesh: Mesh, pattern: SeedPattern,
                    accel: str = "uniq", n_key_words: int = 0):
    """Shard one prepared table over the mesh's tp axis and place it.

    Shard t holds buckets [k_t, k_{t+1}) of :func:`balanced_bounds` of
    the table's counter.  The same bucket-range layout as
    :func:`shard_device_table`, but each shard is exact-size and its
    accelerating structure is built on its own device from its own entries
    (``ops/device_index`` builders): a bucket lives on one shard and
    word-0 runs break at every bucket start, so a shard's uniq runs are
    walt_tpu's global runs rebased to the shard.
    ``accel``: "uniq" or "key16" (see :func:`shard_device_table`);
    ``n_key_words``: packed u32 key words stored beside the uniq runs (3
    for the ``exact_b`` path; the fast path reads none).  ``dt.key_words``
    is not used.

    Returns (grid, uniq_bits): ``grid[d][t]`` is the dict of shard t's
    tensors on ``mesh.devices[d][t]`` (``key_base`` an int), the same
    object for every dp row on one device; ``uniq_bits`` is the probe count
    of the largest shard (walt_tpu's global count).  Each shard's
    placement and builds on each device is one ``setup.place`` span.
    """
    if accel not in ("uniq", "key16"):
        raise ValueError(f"unknown accel {accel!r}")
    if accel == "key16" and n_key_words:
        raise ValueError("key16 shards store no u32 key words")
    tp = mesh.shape["tp"]
    kb, bounds = _shard_bounds(dt.counter, tp, f"shard_and_place(tp={tp})")
    genome = {}  # device -> (pseq, start_index)
    placed = {}  # (shard, device) -> shard dict
    uniq_bits = 0
    for t in range(tp):
        a, b = int(bounds[t]), int(bounds[t + 1])
        k0, k1 = int(kb[t]), int(kb[t + 1])
        for device in dict.fromkeys(row[t] for row in mesh.devices):
            with perf.stage("setup.place"):
                if device not in genome:
                    genome[device] = (packing.from_np(dt.pseq, device),
                                      packing.from_np(dt.start_index, device))
                pseq, start_index = genome[device]
                counter = packing.from_np(
                    dt.counter[k0:k1 + 1] - dt.counter[k0], device)
                index = packing.from_np(dt.index[a:b], device)
                sh = dict(
                    key_base=k0, pseq=pseq, start_index=start_index,
                    counter=counter, bucket_flagged=torch.from_numpy(
                        dt.bucket_flagged[k0:k1]).to(device),
                )
                if accel == "key16":
                    sh["key_words"] = _at_least_one(
                        device_index.build_key16_device(pseq, index, pattern))
                else:
                    uw, uo, uc, bits = device_index.build_uniq_device(
                        pseq, index, counter, pattern)
                    uniq_bits = max(uniq_bits, bits)
                    sh.update(uniq_words=_at_least_one(uw), uniq_off=uo,
                              uniq_counter=uc)
                    sh["key_words"] = (
                        device_index.build_key_words_device(
                            pseq, index, pattern, n_key_words=n_key_words)
                        if n_key_words else
                        torch.zeros((1, 1), dtype=torch.int32, device=device))
                sh["index"] = _at_least_one(index)
            placed[t, device] = sh
    grid = [[placed[t, row[t]] for t in range(tp)] for row in mesh.devices]
    return grid, uniq_bits


_MAX_SHIFT = 8  # seed shifts are < pattern_len <= 7 for patterns 3/5/7


def merge_gathered(cs_g, cp_g, cm_g, fb_any, cand_slab: int,
                   n_seeds: int = _MAX_SHIFT):
    """Merge gathered per-shard candidate slabs into examination order.

    ``cs_g``/``cp_g``/``cm_g``: (T, Bl, C) seed / position / mismatch slabs
    of the T shards; ``fb_any``: (Bl,) OR of their fallback masks.  Each
    shard's slab is seed-major ordered, so the merge is a seed-GROUP
    concatenation by rank arithmetic and one scatter: a slot goes to
    (candidates of smaller seeds, all shards) + (same-seed candidates of
    earlier shards) + (its rank inside its shard's seed group).  Returns
    (seed, pos, mm, cnt, fallback) like one shard; a read with more than C
    merged candidates falls back.
    """
    T, Bl, C = cs_g.shape
    dev = cs_g.device
    valid = cs_g >= 0
    seeds = torch.clamp(cs_g.to(torch.int64), 0, n_seeds - 1)
    onehot = (torch.arange(n_seeds, dtype=torch.int64, device=dev)
              == seeds[..., None]) & valid[..., None]
    c_ts = onehot.sum(2)  # (T, Bl, S)
    # within-shard exclusive seed-group starts, gathered per slot
    off_slot = torch.gather(torch.cumsum(c_ts, -1) - c_ts, 2, seeds)
    rank = torch.arange(C, dtype=torch.int64, device=dev) - off_slot
    # global exclusive base: smaller seeds across ALL shards, plus the same
    # seed on earlier shards (vacuous when buckets are disjoint)
    tot_s = c_ts.sum(0)  # (Bl, S)
    g_s = torch.cumsum(tot_s, -1) - tot_s
    prior_t = torch.cumsum(c_ts, 0) - c_ts  # (T, Bl, S)
    base_slot = torch.gather(g_s[None] + prior_t, 2, seeds)
    # destinations past the slab land in a spare column, sliced off
    dest = torch.where(valid, torch.clamp(base_slot + rank, max=C), C)
    b_idx = torch.arange(Bl, dtype=torch.int64, device=dev)[None, :, None] \
        .expand(T, Bl, C)

    def scatter(vals, fill):
        out = torch.full((Bl, C + 1), fill, dtype=vals.dtype, device=dev)
        out[b_idx, dest] = vals
        return out[:, :C]

    total = valid.sum((0, 2))
    return (scatter(cs_g, -1), scatter(cp_g, 0), scatter(cm_g, 0),
            torch.clamp(total, max=C).to(torch.int32), fb_any | (total > C))


def _row_reads(preads, lens, mesh: Mesh, d: int) -> dict:
    """dp row ``d``'s slice of a chunk, on each distinct device of the row."""
    dp = mesh.shape["dp"]
    if preads.shape[0] % dp:
        raise ValueError(f"batch of {preads.shape[0]} reads does not split "
                         f"over dp={dp}")
    bl = preads.shape[0] // dp
    pr, ln = preads[d * bl:(d + 1) * bl], lens[d * bl:(d + 1) * bl]
    return {dev: (pr.to(dev, non_blocking=True), ln.to(dev, non_blocking=True))
            for dev in dict.fromkeys(mesh.devices[d])}


def _gather(tensors, dst):
    """tp all_gather: every shard's tensor copied to ``dst``, stacked."""
    return torch.stack([t.to(dst, non_blocking=True) for t in tensors])


def _own(t, dst):
    """A graph output copied to ``dst`` (on its own device too): the lane's
    next replay may overwrite the output."""
    return t.to(dst, non_blocking=True, copy=True)


def _cat_rows(rows, mesh: Mesh, dim: int = 0):
    """The dp rows' results concatenated on the mesh's first device."""
    dst = mesh.devices[0][0]
    return torch.cat([r.to(dst, non_blocking=True) for r in rows], dim)


def _map_shard(reads, b, max_mm, sh: dict, **kw):
    """``pipeline.map_strand_core`` of one dp row's reads on one shard."""
    preads, lens = reads
    return pipeline.map_strand_core(
        preads, lens, b, max_mm, sh["pseq"], sh["counter"], sh["index"],
        sh["key_words"], sh["start_index"], sh["bucket_flagged"],
        uniq_words=sh.get("uniq_words"), uniq_off=sh.get("uniq_off"),
        uniq_counter=sh.get("uniq_counter"), key_base=sh["key_base"], **kw)


# ---- the single-device parts of a row, each one cached graph -------------
def _merge_row(outs, cand_slab: int, n_seeds: int):
    """A strand row's merge on its first device: the shards' slabs
    (``_map_shard`` outputs, already on that device) stacked and merged."""
    cs, cp, cm, _, fb = (torch.stack([o[k] for o in outs])
                         for k in range(5))
    return merge_gathered(cs, cp, cm, fb.any(0), cand_slab, n_seeds)


def _shard_summaries(reads, b, max_mm, sh: dict, **kw):
    """One shard's strand pass and its ``segment_summaries``: (summaries,
    fallback)."""
    cs, cp, cm, _, fb = _map_shard(reads, b, max_mm, sh, **kw)
    return (se_fold.segment_summaries(cs, cp, cm,
                                      get_pattern(kw["pattern_name"])), fb)


def _fold_row(parts, max_mm: int, pattern_name: str):
    """An SE row's fold on its first device: ``parts[table][shard]`` =
    (summaries, fallback), joined per table, folded, packed."""
    summaries = [se_fold.combine_summaries([p[0] for p in shards])
                 for shards in parts]
    fallback = torch.stack([p[1] for shards in parts for p in shards]).any(0)
    return se_fold.pack_se_result(
        *se_fold.fold_summaries(summaries, max_mm, get_pattern(pattern_name)),
        fallback)


def _mate_shard(reads, b, max_mm, shards, *, flat_factor: int, search_bits,
                uniq_bits, **kw):
    """One shard's mate step: both strand tables' passes (``shards``, '+'
    first) and their flat compaction."""
    wls, cnts, fallback = [], [], None
    for sh, bits, ubits in zip(shards, search_bits, uniq_bits):
        wl, cnt, fb = _map_shard(reads, b, max_mm, sh, search_bits=bits,
                                 uniq_bits=ubits, emit_wl=True, **kw)
        wls.append(wl)
        cnts.append(cnt)
        fallback = fb if fallback is None else (fallback | fb)
    return pe_map.flat_from_wl(wls, cnts, fallback, flat_factor,
                               kw["cand_slab"])


def map_strand_sharded(preads, lens, b: int, max_mm: int, table, *,
                       mesh: Mesh, pattern_name: str, ag_wildcard: bool,
                       search_bits: int,
                       verify_slab: int = pipeline.VERIFY_SLAB,
                       cand_slab: int = pipeline.CAND_SLAB,
                       seeds: tuple | None = None,
                       wl_factor: float = pipeline.WL_FACTOR,
                       exact_b: bool = False, uniq_bits: int = 0,
                       full_mask: bool = False,
                       graphs: StepCache | None = None):
    """Sharded ``map_strand_core``: candidate slabs of one table.

    preads: (B, W) int32 packed reads, B a multiple of dp; ``table``: the
    grid of :func:`shard_and_place`.  Each shard's slab is gathered to its
    dp row's first device and merged (:func:`merge_gathered`).  Returns
    (cand_seed, cand_pos, cand_mm, cand_cnt, fallback) as the single-device
    pipeline does, on the mesh's first device.  ``graphs``: the step cache
    the rows' parts replay from (the backend's); None makes one for this
    call.
    """
    kw = dict(pattern_name=pattern_name, ag_wildcard=ag_wildcard,
              search_bits=search_bits, verify_slab=verify_slab,
              cand_slab=cand_slab, seeds=seeds, wl_factor=wl_factor,
              exact_b=exact_b, uniq_bits=uniq_bits, full_mask=full_mask,
              tp_route=mesh.shape["tp"])
    n_seeds = get_pattern(pattern_name).pattern_len
    graphs = StepCache() if graphs is None else graphs

    def row(d):
        devices = mesh.devices[d]
        reads = _row_reads(preads, lens, mesh, d)
        outs = [[_own(x, devices[0]) for x in graphs.run(
                    _map_shard, (reads[dev],), b, max_mm, sh, lane=d, **kw)]
                for dev, sh in zip(devices, table[d])]
        return graphs.run(_merge_row, (outs,), cand_slab, n_seeds, lane=d)

    rows = mesh.run_rows(row)
    return tuple(_cat_rows([r[k] for r in rows], mesh) for k in range(5))


def map_single_end_sharded(preads, lens, b: int, max_mm: int, tables, *,
                           mesh: Mesh, pattern_name: str, ag_wildcard: bool,
                           search_bits: tuple,
                           verify_slab: int = pipeline.VERIFY_SLAB,
                           cand_slab: int = pipeline.CAND_SLAB,
                           seeds: tuple | None = None,
                           wl_factor: float = pipeline.WL_FACTOR,
                           exact_b: bool = False, uniq_bits: tuple = (0, 0),
                           full_mask: bool = False,
                           graphs: StepCache | None = None):
    """Sharded ``se_fold.map_single_end_device``.

    ``tables``: two grids of :func:`shard_and_place` ('+' strand first).
    Shards exchange SUMMARIES, not slabs: a (read, seed) bucket lives on
    one shard, so each shard's ``segment_summaries`` are gathered to the dp
    row's first device and joined by ``combine_summaries``, and the
    BestMatch fold runs there.  Returns the (B, 3) packed result of
    ``map_single_end_device`` on the mesh's first device.  ``graphs``: as
    for :func:`map_strand_sharded`.
    """
    kw = dict(pattern_name=pattern_name, ag_wildcard=ag_wildcard,
              verify_slab=verify_slab, cand_slab=cand_slab, seeds=seeds,
              wl_factor=wl_factor, exact_b=exact_b, full_mask=full_mask,
              tp_route=mesh.shape["tp"])
    graphs = StepCache() if graphs is None else graphs

    def row(d):
        devices = mesh.devices[d]
        reads = _row_reads(preads, lens, mesh, d)
        dst = devices[0]
        parts = []
        for table, bits, ubits in zip(tables, search_bits, uniq_bits):
            shards = []
            for dev, sh in zip(devices, table[d]):
                summ, fb = graphs.run(_shard_summaries, (reads[dev],), b,
                                      max_mm, sh, lane=d, search_bits=bits,
                                      uniq_bits=ubits, **kw)
                shards.append(({k: _own(v, dst) for k, v in summ.items()},
                               _own(fb, dst)))
            parts.append(shards)
        return graphs.run(_fold_row, (parts,), max_mm, pattern_name, lane=d)

    return _cat_rows(mesh.run_rows(row), mesh)


def map_mate_sharded(preads, lens, b: int, max_mm: int, tables, *,
                     mesh: Mesh, pattern_name: str, ag_wildcard: bool,
                     search_bits: tuple, verify_slab: int, cand_slab: int,
                     wl_factor: float, flat_factor: int,
                     exact_b: bool = False, uniq_bits: tuple = (0, 0),
                     full_mask: bool = False,
                     graphs: StepCache | None = None):
    """Sharded ``pe_map.map_mate_device``.

    Each shard flat-compacts its own two strand worklists
    (``pe_map.flat_from_wl``; a (read, seed) bucket lives on one shard, so
    the union of the shard streams is the candidate set), and the streams
    are gathered, not merged: the examination-order interleave (seed asc
    across shards) is the backend's host decode.  Returns (meta (T, B),
    flat (T, dp*M_l, 2)) on the mesh's first device, row t being shard t's
    dp-segmented stream with M_l = flat_factor * B/dp rows per segment --
    walt_tpu's layout.  ``graphs``: as for :func:`map_strand_sharded`.
    """
    kw = dict(pattern_name=pattern_name, ag_wildcard=ag_wildcard,
              verify_slab=verify_slab, cand_slab=cand_slab,
              wl_factor=wl_factor, exact_b=exact_b, full_mask=full_mask,
              tp_route=mesh.shape["tp"], flat_factor=flat_factor,
              search_bits=tuple(search_bits), uniq_bits=tuple(uniq_bits))
    graphs = StepCache() if graphs is None else graphs

    def row(d):
        devices = mesh.devices[d]
        reads = _row_reads(preads, lens, mesh, d)
        shard_meta, shard_flat = [], []
        for t, dev in enumerate(devices):
            meta, flat = graphs.run(
                _mate_shard, (reads[dev],), b, max_mm,
                tuple(table[d][t] for table in tables), lane=d, **kw)
            shard_meta.append(_own(meta, devices[0]))
            shard_flat.append(_own(flat, devices[0]))
        return torch.stack(shard_meta), torch.stack(shard_flat)

    metas, flats = zip(*mesh.run_rows(row))
    return _cat_rows(metas, mesh, 1), _cat_rows(flats, mesh, 1)
