"""One run of one cell: set-up, the measured window, the output check.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names the
cell, its configuration's file (genome layout, seed pattern, flags, and
``tp``, how many ways the index is split over the cell's cards; 1 when the
file has no ``tp``), its traffic file ``portbench/traffic/<traffic>.json``
(read lengths, trimming, fragments, batch, pool, the check's sample) and
its metrics, each read by ``portbench/metrics/<name>.py``.  A new cell,
configuration, traffic mix or metric is new files and entries, with no edit
here.

Set-up makes the inputs from the seed, builds what a user has before a
mapping job (the synthetic genome and the port's ``makedb`` index of it,
once per checkout, in ``portbench/cache/``; later runs load both), makes
one ``TorchBackend`` over the cell's ``chips`` cards, and maps
``warm_batches`` batches through the driver, which places the tables and
captures the steps' graphs.  A one-card cell builds the backend on
``cuda:0`` with no mesh.  A cell of ``chips`` C > 1 builds the port's mesh
(``sharded.make_mesh`` over ``cuda:0 .. cuda:C-1`` at the configuration's
tp, as ``cli --tp`` does): dp = C / tp rows of tp cards, so a tp cell and a
dp cell (ROADMAP C1) differ only in their configuration's ``tp``.
``setup_s`` is all of that but the making (or loading) of the synthetic
genome and the making of the read pool, which a user mapping a library
does not pay.  The window then feeds whole ``-N`` batches of the cycled
read pool to ``process_single_end`` / ``process_paired_end`` until
``seconds`` have passed, and ends when the last output is written.  Reads
come from an in-memory stream; the MR output goes to an anonymous
in-memory file.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np

from portbench import gen

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "walt_tpu")


class Refusal(RuntimeError):
    """The run cannot be made here (no card, a cell that does not exist)."""


# ---- the data that make a cell ------------------------------------------
def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(root: str, spec: dict, workload: str):
    """(cell, configuration, traffic) dicts for ``workload``."""
    cell = next((w for w in spec["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise Refusal(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def cell_metrics(spec: dict, workload: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics this cell
    reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]


def metric_reader(root: str, name: str):
    """``read(run) -> float | None`` of ``portbench/metrics/<name>.py``."""
    import importlib.util

    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---- inputs -------------------------------------------------------------
def make_genome(config: dict) -> gen.Genome:
    g = config["genome"]
    return gen.make_genome_repetitive(g["lengths"], g["names"], g["seed"])


def _sources_key(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        if os.path.isdir(p):
            for dp, _, fs in sorted(os.walk(p)):
                for f in sorted(fs):
                    if f.endswith((".py", ".cpp", ".hpp")):
                        with open(os.path.join(dp, f), "rb") as fh:
                            h.update(fh.read())
        elif os.path.isfile(p):
            with open(p, "rb") as fh:
                h.update(fh.read())
        else:
            h.update(str(p).encode())
    return h.hexdigest()[:16]


def config_tp(config: dict) -> int:
    """How many ways the configuration splits its index (its ``tp``; 1
    without the key)."""
    tp = config.get("tp", 1)
    if not isinstance(tp, int) or tp < 1:
        raise Refusal(f"configuration {config['name']!r}: tp {tp!r} is not "
                      "a whole number of 1 or more")
    return tp


def prepare_inputs(root: str, config: dict, mark=lambda stage: None):
    """(genome, index path) of the configuration: the synthetic genome and
    the port's four-table index of it, made once per checkout and kept in
    ``portbench/cache/<config>-<key>/``, the key taken from the
    configuration, the generator and the port's index sources.  A directory
    without its ``ok`` marker is made again whole; one with it is loaded.
    ``mark("genome")`` and ``mark("index")`` are called as each is ready."""
    import walt_tpu_torch

    port = os.path.dirname(os.path.abspath(walt_tpu_torch.__file__))
    key = _sources_key(json.dumps(config, sort_keys=True),
                       os.path.abspath(gen.__file__),
                       os.path.join(port, "index"), os.path.join(port,
                                                                 "native"))
    d = os.path.join(root, "portbench", "cache", f"{config['name']}-{key}")
    index = os.path.join(d, "genome.dbindex")
    if os.path.exists(os.path.join(d, "ok")):
        genome = gen.load_genome(d)
        mark("genome")
        mark("index")
        return genome, index
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    genome = make_genome(config)
    gen.save_genome(genome, d)
    mark("genome")
    fasta = os.path.join(d, "genome.fa")
    gen.write_fasta(genome, fasta)
    # the user's offline makedb step, in a process of its own as a user
    # runs it (its allocator tuning must not reach the mapping process)
    import subprocess

    subprocess.run([sys.executable, "-m", "walt_tpu_torch.cli", "index",
                    "-c", fasta, "-o", index, "--seed-pattern",
                    str(config["seed_pattern"])], check=True,
                   cwd=os.path.dirname(port))
    os.remove(fasta)
    open(os.path.join(d, "ok"), "w").close()
    mark("index")
    return genome, index


def make_backend(chips: int, tp: int, device: str):
    """The port's ``TorchBackend`` over the cell's ``chips`` cards
    (``device`` "cuda"; the CPU tests pass "cpu" and get a virtual mesh of
    ``chips`` CPU devices): on one card the backend of ``cuda:0`` with no
    mesh, else ``sharded.make_mesh`` over the cards at ``tp``, which
    divides ``chips``, with dp = chips / tp rows."""
    from walt_tpu_torch.core.backends import get_backend
    from walt_tpu_torch.parallel import sharded

    if chips == 1:
        return get_backend("torch", device=device + ":0" if device == "cuda"
                           else device, mesh=None, tp=1)
    cards = ([f"cuda:{i}" for i in range(chips)] if device == "cuda"
             else [device] * chips)
    return get_backend("torch", device=cards[0],
                       mesh=sharded.make_mesh(cards, tp=tp), tp=tp)


class Pool:
    """The cell's read pool, made from the seed: codes, lengths and FASTQ
    text of each mate (one for SE), cycled batch by batch."""

    def __init__(self, genome, traffic: dict, seed: int):
        n, L = int(traffic["pool"]), int(traffic["read_len"])
        bis, err = traffic.get("bis_rate", 0.75), traffic.get("err_rate",
                                                              0.01)
        if traffic["mode"] == "se":
            codes, lens, _ = gen.sample_reads(genome, n, L, [seed, 1], bis,
                                              err)
            if traffic.get("trim"):
                lens = gen.trimmed_lengths(n, traffic["trim"], [seed, 2])
            mates = [(codes, lens)]
        else:
            lo, hi = traffic["frag"]
            c1, l1, c2, l2 = gen.sample_pairs(genome, n, L, [seed, 1], lo,
                                              hi, bis, err)
            mates = [(c1, l1), (c2, l2)]
        self.n = n
        self.mates = mates
        self.text = [gen.fastq_records(c, ln) for c, ln in mates]

    def read(self, mate: int, i: int) -> np.ndarray:
        codes, lens = self.mates[mate]
        return codes[i, : int(lens[i])]


class BatchStream:
    """A read-only file of FASTQ text, served batch by batch from the
    pool: batch j holds pool records j*N .. j*N+N-1 (mod the pool).  The
    leader (SE, or mate 1) starts a batch only while ``until()`` is false
    and fewer than ``max_batches`` were served; a follower (mate 2) serves
    exactly the batches its leader started."""

    def __init__(self, text, offsets, batch: int, until=None,
                 max_batches=None, leader=None):
        self.text = memoryview(text)
        self.off = offsets
        self.P = offsets.shape[0] - 1
        self.N = batch
        self.until, self.max_batches, self.leader = until, max_batches, leader
        self.batches = 0
        self._pieces = []

    def _next_batch(self) -> bool:
        if self.leader is not None:
            if self.batches >= self.leader.batches:
                return False
        elif (self.max_batches is not None and
              self.batches >= self.max_batches) or (
                self.until is not None and self.until()):
            return False
        a = (self.batches * self.N) % self.P
        z = a + self.N
        self._pieces = [(int(self.off[a]), int(self.off[min(z, self.P)]))]
        while z > self.P:
            z -= self.P
            self._pieces.append((0, int(self.off[min(z, self.P)])))
        self.batches += 1
        return True

    def read(self, n: int = -1) -> bytes:
        while not self._pieces:
            if not self._next_batch():
                return b""
        s, z = self._pieces[0]
        take = z - s if n is None or n < 0 else min(n, z - s)
        if s + take == z:
            self._pieces.pop(0)
        else:
            self._pieces[0] = (s + take, z)
        return bytes(self.text[s: s + take])

    def close(self) -> None:
        pass

    @property
    def fed(self) -> int:
        return self.batches * self.N


class MemOutput:
    """An anonymous in-memory file standing at a path the driver can open
    (a link to it in a private directory), with room beside it for the
    ``.mapstats`` file."""

    def __init__(self, tmp: str, name: str):
        self.fd = os.memfd_create("portbench-" + name)
        self.path = os.path.join(tmp, name)
        os.symlink(f"/proc/{os.getpid()}/fd/{self.fd}", self.path)

    def data(self):
        """The file's bytes, mapped (no copy; a single read stops at 2 GiB)."""
        import mmap

        size = os.fstat(self.fd).st_size
        return mmap.mmap(self.fd, size, prot=mmap.PROT_READ) if size else b""

    def stats(self) -> str:
        with open(self.path + ".mapstats") as f:
            return f.read()

    def close(self) -> None:
        os.close(self.fd)


# ---- the run --------------------------------------------------------------
def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, faults=None) -> dict:
    """One run: (the result line's dict, ending in ``checked``; an info
    dict of set-up split, spans, batches and graphs for the info line).

    ``device`` is "cuda" for a benchmark run; the CPU tests pass "cpu".
    ``faults`` (tests only) breaks the backend before the window."""
    import torch

    from portbench import hostinfo, outcheck

    spec = load_spec(root)
    cell, config, traffic = find_cell(root, spec, workload)
    chips, tp = int(cell["chips"]), config_tp(config)
    if chips % tp:
        raise Refusal(f"tp {tp} does not divide the cell's {chips} card(s)")
    marks = [("start", t_start), ("imports", time.perf_counter())]
    genome, index = prepare_inputs(
        root, config, lambda stage: marks.append((stage,
                                                  time.perf_counter())))
    pool = Pool(genome, traffic, seed)
    marks.append(("pool", time.perf_counter()))

    from walt_tpu_torch import perf
    from walt_tpu_torch.core import errors
    from walt_tpu_torch.core.paired_end import process_paired_end
    from walt_tpu_torch.core.single_end import process_single_end

    backend = make_backend(chips, tp, device)
    used = (backend.mesh.distinct() if backend.mesh is not None
            else [backend.device])
    backend_mesh = (dict(backend.mesh.shape) if backend.mesh is not None
                    else None)
    if device == "cuda" and len(used) != chips:
        raise Refusal(f"the backend uses {len(used)} card(s), the cell "
                      f"states {chips}")
    flags = config["flags"]
    pe = traffic["mode"] == "pe"
    N = int(traffic["batch"])
    pattern = str(config["seed_pattern"])
    tmp = tempfile.mkdtemp(prefix="portbench-")

    def drive(streams, out):
        backend.reset_adaptive()  # as the CLI does before each file
        common = dict(batch_size=N, max_mismatches=flags["m"], b=flags["b"],
                      backend=backend, pattern_name=pattern)
        if pe:
            return process_paired_end(index, streams[0], streams[1],
                                      out.path, top_k=flags["k"],
                                      frag_range=flags["L"], **common)
        return process_single_end(index, streams[0], out.path, **common)

    def streams(**kw):
        lead = BatchStream(*pool.text[0], N, **kw)
        return [lead] + [BatchStream(*t, N, leader=lead)
                         for t in pool.text[1:]]

    warm = MemOutput(tmp, "warm.mr")
    drive(streams(max_batches=int(traffic.get("warm_batches", 2))), warm)
    warm.close()
    marks.append(("warm_up", time.perf_counter()))

    if faults is not None:
        faults(backend)
    for k in errors.degraded_batches:
        errors.degraded_batches[k] = 0
    # the set-up's garbage and dirty pages (a fresh index) are not the
    # window's to pay
    gc.collect()
    os.sync()
    perf.reset()
    graphs_before = backend.graphs.stats()
    out = MemOutput(tmp, "window.mr")
    spans = prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import devtrace

        spans = devtrace.Spans()
        real_add = perf.add

        def add(stage, secs, n=1):
            real_add(stage, secs, n)
            spans.add(stage, secs)

        perf.add = add
        for nm in ("map_single_end", "map_mate_slabs_begin",
                   "map_mate_slabs_finish"):
            if hasattr(backend, nm):
                setattr(backend, nm,
                        spans.wrap("backend." + nm, getattr(backend, nm)))
        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    host0 = hostinfo.snapshot()
    t0 = time.perf_counter()
    split = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    inputs_s = split["genome"] + split["pool"]
    setup_s = t0 - t_start - inputs_s
    fed_streams = streams(until=lambda: time.perf_counter() - t0 >= seconds)
    if trace:
        with record_function("portbench.window"):
            drive(fed_streams, out)
    else:
        drive(fed_streams, out)
    window_s = time.perf_counter() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    host1 = hostinfo.snapshot()
    if trace:
        prof.stop()
        perf.add = real_add
    n_fed = fed_streams[0].fed
    span_s = dict(perf._stages)
    degraded = sum(errors.degraded_batches.values())
    graphs_after = backend.graphs.stats()
    dev = backend.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = max(int(torch.cuda.max_memory_reserved(d)) for d in used)
        kind = torch.cuda.get_device_name(dev)
        count = len(used)
    else:
        peak, kind, count = 0, "cpu", 0
    tr = None
    if trace:
        tr = devtrace.reduce(prof, "portbench.window", spans,
                             [d.index for d in used if d.type == "cuda"])
        del prof
    data, stats = out.data(), out.stats()
    shutil.rmtree(tmp, ignore_errors=True)
    # free the program's state before the reference runs on the card
    for nm in ("map_single_end", "map_mate_slabs_begin",
               "map_mate_slabs_finish"):
        backend.__dict__.pop(nm, None)
    backend.free_tables()
    del backend
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checked = outcheck.check(genome, config, traffic, pool, data, stats,
                             n_fed, seed, ref_device=str(dev))
    check_s = time.perf_counter() - t_check
    if hasattr(data, "close"):
        data.close()
    out.close()
    probe = hostinfo.probe()
    run = dict(mode=traffic["mode"], n=n_fed, window_s=window_s,
               setup_s=setup_s, peak_bytes=peak, spans=span_s, trace=tr)
    kind_metrics = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(spec, workload, kind_metrics):
        v = metric_reader(root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": count, "memory_peak_bytes": peak}
    result = {"correct": checked["correct"], "attempted": n_fed,
              "failed": checked["missing"] + degraded * N,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    result["checked"] = checked["numbers"]
    info = dict(setup_s=setup_s, window_s=window_s,
                setup_split_s={k: round(v, 3) for k, v in split.items()},
                inputs_s=round(inputs_s, 3), devices=[str(d) for d in used],
                mesh=backend_mesh, fed=n_fed,
                batches=fed_streams[0].batches, degraded_batches=degraded,
                spans_s={k: round(v, 3) for k, v in span_s.items()},
                window_rusage={k: round(getattr(ru1, k) - getattr(ru0, k), 3)
                               for k in ("ru_utime", "ru_stime", "ru_minflt",
                                         "ru_majflt", "ru_nvcsw",
                                         "ru_nivcsw")},
                graphs_before=graphs_before, graphs_after=graphs_after,
                unjudged=checked.get("unjudged", 0), check_s=round(check_s, 3),
                sampled=checked["sampled"], placement=hostinfo.placement(),
                host_window=hostinfo.window(host0, host1), probe=probe)
    if trace:
        info["busy_s_by_card"] = tr["busy_s_by_card"]
    return result, info


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})
