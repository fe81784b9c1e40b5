"""Device steps as CUDA graphs: the port's counterpart of ``jax.jit``.

walt_tpu compiles each device step once per set of static arguments
(``jax.jit`` with ``static_argnames``: ``map_single_end_device``,
``map_mate_device``, ``map_strand_device`` and the sharded steps) and then
dispatches it once per chunk.  :class:`StepCache` does the same with
``torch.cuda.CUDAGraph``: the first call of a key runs the step once on a
side stream (the warm-up: it builds and loads the kernels and touches every
torch kernel the step launches), then captures it; every call, the first
included, copies the chunk into the graph's static input buffers and
replays it.  A replay is one ``cudaGraphLaunch`` where the eager step
issues about a thousand ops from Python, so a dp row's thread gives up the
interpreter lock once per step instead of at every op.

The key is the step function, the device, the lane (below), the inputs'
structure, shapes and dtypes, and every other argument: walt_tpu's static
arguments, ``b`` and ``max_mm`` (the port bakes them into the step), and
the identity of each tensor among them (the resident tables, whose
pointers the graph bakes in).  An entry keeps those tensors alive, so
:meth:`StepCache.drop` must be called when they are freed (the backend does
it in ``free_tables`` and when it replaces a table).

Outputs are the graph's own tensors: the next replay of any graph of the
same lane on that device may overwrite them, so the caller copies them out
(a device copy, or a host copy started at once) before it runs another
step of that lane.  Each lane has one memory pool and one side stream per
device: a mesh's dp rows are lanes, so rows that replay at once from their
threads never share a pool, while the graphs of one row share one.
Captures run in ``thread_local`` error mode, one at a time in the process:
another row's thread may launch, allocate or copy while a capture runs.
Between the warm-up and the capture the caching allocator's free blocks
are handed back (``torch.cuda.empty_cache``), so a step's memory is its
pool and not the pool plus the warm-up's blocks.

Each new entry (a capture on the card, the stand-in's first call on the
CPU) adds one to the ``graphs.captures`` counter of ``walt_tpu_torch.perf``:
one inside a timed window is a step built again.

The fused verify stage counts its launches in Python
(``verify.count_launch``), which runs at capture and not at replay: the
warm-up and the capture count into a tally (``verify.launch_tally``), and
every replay adds the captured counts, so a counter still says how many
times the kernel ran.

On the CPU there is no capture: a stand-in runs the step and copies its
result into the tensors the key's first call returned, and returns those,
so callers see the aliasing of a real graph.  A failed capture raises (an
out-of-memory error included, which the backend turns into
``HbmBudgetError``); there is no fallback to the eager step.  The eager
step itself stays for the CPU and for calls with a stage recorder
(``ops/stages``), which the caller makes on the step function directly.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from walt_tpu_torch import perf
from walt_tpu_torch.ops import verify

#: captures in this process run one at a time (the caching allocator then
#: routes one capture's allocations at a time into a graph pool)
_CAPTURE_LOCK = threading.Lock()


def _spec(tree, leaves: list):
    """Hashable structure of ``tree`` (tensors in tuples, lists and dicts)
    with each tensor as its (shape, dtype); appends the tensors to
    ``leaves`` in order."""
    if torch.is_tensor(tree):
        leaves.append(tree)
        return ("t", tuple(tree.shape), tree.dtype)
    if isinstance(tree, (tuple, list)):
        return ("(" if isinstance(tree, tuple) else "[",
                tuple(_spec(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return ("{", tuple((k, _spec(v, leaves)) for k, v in tree.items()))
    raise TypeError(f"graphs: a step's inputs and outputs hold tensors in "
                    f"tuples, lists and dicts, not {type(tree).__name__}")


def _build(spec, leaves):
    """The tree of :func:`_spec` with the tensors taken from the iterator
    ``leaves``."""
    kind, body = spec[0], spec[1]
    if kind == "t":
        return next(leaves)
    if kind == "{":
        return {k: _build(s, leaves) for k, s in body}
    items = [_build(s, leaves) for s in body]
    return tuple(items) if kind == "(" else items


def _static(obj, resident: list):
    """Hashable key of a step's other arguments: a tensor by identity
    (appended to ``resident``), containers by content."""
    if torch.is_tensor(obj):
        resident.append(obj)
        return ("tensor", id(obj))
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,
                tuple(_static(x, resident) for x in obj))
    if isinstance(obj, dict):
        return ("dict", tuple(sorted(
            (k, _static(v, resident)) for k, v in obj.items())))
    hash(obj)  # raises for an argument that cannot be part of a key
    return obj


class _Entry:
    """One cached step: its graph (None on the CPU), static input buffers,
    outputs and their tensors in order, launches per replay, the resident
    tensors of its key, and its (lane, device)."""

    __slots__ = ("graph", "static", "outputs", "out_leaves", "launches",
                 "resident", "lane")

    def __init__(self, graph, static, outputs, launches, resident, lane):
        self.graph, self.static, self.outputs = graph, static, outputs
        self.out_leaves = []
        _spec(outputs, self.out_leaves)
        self.launches, self.resident, self.lane = launches, resident, lane


class StepCache:
    """One CUDA graph per step key (see the module docstring)."""

    def __init__(self):
        self._entries = {}
        self._pools = {}  # (lane, device) -> (graph pool handle, stream)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def run(self, fn, inputs, *args, lane: int = 0, **kw):
        """``fn(*inputs, *args, **kw)`` as a graph replay on the card (the
        stand-in on the CPU).  ``inputs``: the tuple of per-call arguments,
        tensors in tuples, lists and dicts, copied into the graph's static
        buffers; ``args`` and ``kw``: everything else, part of the key.
        ``lane``: the caller's lane (a mesh's dp row).  Returns the
        graph's outputs, valid until the lane's next step on the device."""
        if kw.get("stages") is not None:
            raise ValueError("graphs: a stage recorder runs the eager step; "
                             "call the step function itself")
        leaves = []
        spec = _spec(tuple(inputs), leaves)
        if not leaves:
            raise ValueError("graphs: a step needs a tensor input")
        device = leaves[0].device
        resident = []
        key = (fn, device, lane, spec, _static(args, resident),
               _static(kw, resident))
        with self._lock:
            entry = self._entries.get(key)
        if device.type == "cpu":
            out = fn(*inputs, *args, **kw)
            if entry is None:
                entry = _Entry(None, None, out, {}, resident, lane)
                with self._lock:
                    self._entries[key] = entry
                perf.count("graphs.captures")
                return out
            got = []
            _spec(out, got)
            for dst, src in zip(entry.out_leaves, got):
                dst.copy_(src)
            return entry.outputs
        if device.type != "cuda":
            raise ValueError(f"graphs: unsupported device {device}")
        if entry is None:
            entry = self._capture(fn, spec, leaves, args, kw, device, lane,
                                  resident)
            with self._lock:
                self._entries[key] = entry
            perf.count("graphs.captures")
        else:
            for dst, src in zip(entry.static, leaves):
                dst.copy_(src, non_blocking=True)
        entry.graph.replay()
        for name, n in entry.launches.items():
            verify.count_launch(name, n)
        return entry.outputs

    def _capture(self, fn, spec, leaves, args, kw, device, lane, resident):
        """Warm up and capture one step; the static buffers hold this
        call's inputs."""
        static = [torch.empty(t.shape, dtype=t.dtype,
                              device=device).copy_(t) for t in leaves]

        def call():
            return fn(*_build(spec, iter(static)), *args, **kw)

        with _CAPTURE_LOCK:
            pool, stream = self._pool(lane, device)
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.device(device), torch.cuda.stream(stream), \
                        verify.launch_tally() as tally:
                    call()  # the warm-up, on the side stream
                    stream.synchronize()
                    # hand the warm-up's blocks back before the pool
                    # grows: a graph's pool stays reserved, and the
                    # warm-up's cached blocks would double the step's
                    # memory (no other capture runs now)
                    torch.cuda.empty_cache()
                    tally.clear()
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        out = call()
                        graph.capture_end()
                    except BaseException:
                        self._abort(graph, lane, device)
                        raise
            finally:
                current.wait_stream(stream)
        return _Entry(graph, static, out, dict(tally), resident, lane)

    def _abort(self, graph, lane, device) -> None:
        """End a capture that raised, so the stream leaves capture mode,
        and give the lane a new pool and stream: the failed capture's are
        not used again."""
        with contextlib.suppress(RuntimeError):
            graph.capture_end()
        with self._lock:
            self._pools.pop((lane, device), None)

    def _pool(self, lane, device):
        with self._lock:
            got = self._pools.get((lane, device))
            if got is None:
                got = self._pools[lane, device] = (
                    torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
        return got

    def drop(self, tensors) -> int:
        """Forget every entry whose key holds one of ``tensors`` (tables
        about to be freed), and the pools no graph uses any more.  Returns
        how many entries went."""
        ids = {id(t) for t in tensors}
        with self._lock:
            gone = [k for k, e in self._entries.items()
                    if any(id(t) in ids for t in e.resident)]
            for k in gone:
                del self._entries[k]
            used = {(e.lane, k[1]) for k, e in self._entries.items()}
            for k in [k for k in self._pools if k not in used]:
                del self._pools[k]
        return len(gone)

    def clear(self) -> None:
        """Forget every entry and pool."""
        with self._lock:
            self._entries.clear()
            self._pools.clear()

    def stats(self) -> dict:
        """{device: {"graphs": n, "pool_bytes": b}}: the cached graphs per
        device and the bytes their pools hold on the card (segments of the
        caching allocator's snapshot in one of this cache's pools)."""
        with self._lock:
            out = {}
            for k in self._entries:
                out.setdefault(str(k[1]), {"graphs": 0, "pool_bytes": 0})
                out[str(k[1])]["graphs"] += 1
            pools = {(str(dev), tuple(p)) for (_, dev), (p, _) in
                     self._pools.items() if dev.type == "cuda"}
        if pools:
            for seg in torch.cuda.memory_snapshot():
                where = (f"cuda:{seg['device']}",
                         tuple(seg.get("segment_pool_id", ())))
                if where in pools:
                    out.setdefault(where[0], {"graphs": 0, "pool_bytes": 0})
                    out[where[0]]["pool_bytes"] += seg["total_size"]
        return out
