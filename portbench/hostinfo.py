"""Where a run's process sits on its machine, and what the machine did
while the window ran: CPU affinity, NUMA layout and the card's node,
transparent huge pages, CPU clocks, machine-wide CPU time by kind (steal
included), page faults, and a short fixed probe of the host's speed.

Host-bound cells spread from process to process; these readings, printed
on each run's info line, are what tells the machine's share of that
spread from the process's.  Every reading is taken from ``/proc`` and
``/sys``; one that the machine does not offer reads None.
"""

from __future__ import annotations

import os
import time

import numpy as np

_STAT_KEYS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
              "steal")
_VMSTAT_KEYS = ("pgfault", "pgmajfault", "thp_fault_alloc",
                "thp_fault_fallback", "compact_stall", "numa_miss",
                "numa_foreign")


def _text(path: str):
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def _cpulist(cpus) -> str:
    """Sorted CPU numbers as ranges: 0-3,6."""
    out, run = [], []
    for c in sorted(cpus):
        if run and c == run[-1] + 1:
            run.append(c)
            continue
        if run:
            out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
        run = [c]
    if run:
        out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
    return ",".join(out)


def card_sysfs(bus_id: str | None) -> dict:
    """The card's NUMA node and local CPUs, from its PCI device in sysfs.
    ``bus_id`` as nvidia-smi prints it (00000000:3B:00.0)."""
    if not bus_id or ":" not in bus_id:
        return {"card_numa_node": None, "card_local_cpus": None}
    dom, _, rest = bus_id.strip().lower().partition(":")
    bdf = f"{dom[-4:]}:{rest}"
    base = f"/sys/bus/pci/devices/{bdf}"
    return {"card_numa_node": _text(base + "/numa_node"),
            "card_local_cpus": _text(base + "/local_cpulist")}


def placement() -> dict:
    """Static facts of the process's place: its affinity, the machine's
    CPUs and NUMA nodes, the huge-page modes."""
    try:
        aff = _cpulist(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        aff = None
    thp = "/sys/kernel/mm/transparent_hugepage/"
    return {"affinity": aff, "cpu_count": os.cpu_count(),
            "numa_nodes": _text("/sys/devices/system/node/online"),
            "thp_enabled": _text(thp + "enabled"),
            "thp_defrag": _text(thp + "defrag")}


def _cpu_mhz():
    txt = _text("/proc/cpuinfo")
    if not txt:
        return None
    mhz = [float(line.split(":")[1]) for line in txt.splitlines()
           if line.startswith("cpu MHz")]
    return round(sum(mhz) / len(mhz), 1) if mhz else None


def snapshot() -> dict:
    """Counters that a window's two readings turn into its activity."""
    snap = {"t": time.perf_counter(), "cpu_mhz": _cpu_mhz()}
    stat = _text("/proc/stat")
    if stat:
        head = stat.splitlines()[0].split()[1:]
        snap.update({k: int(v) for k, v in zip(_STAT_KEYS, head)})
    vm = _text("/proc/vmstat")
    if vm:
        got = dict(line.split() for line in vm.splitlines()
                   if line.split()[0] in _VMSTAT_KEYS)
        snap.update({k: int(v) for k, v in got.items()})
    own = _text("/proc/self/stat")
    if own:
        f = own.rsplit(")", 1)[1].split()
        snap.update(self_minflt=int(f[7]), self_majflt=int(f[9]))
    roll = _text("/proc/self/smaps_rollup")
    if roll:
        for line in roll.splitlines():
            k, _, v = line.partition(":")
            if k in ("Rss", "AnonHugePages"):
                snap["self_" + k.lower() + "_kb"] = int(v.split()[0])
    return snap


def window(a: dict, b: dict) -> dict:
    """What happened between two snapshots: the machine's CPU time by kind
    as shares of all its CPUs' time, the counters' growth, the clocks."""
    out = {"cpu_mhz": [a.get("cpu_mhz"), b.get("cpu_mhz")]}
    if all(k in a and k in b for k in _STAT_KEYS):
        d = {k: b[k] - a[k] for k in _STAT_KEYS}
        tot = sum(d.values())
        # a sandbox that keeps no CPU accounting reads all zeros
        out["cpu_share"] = ({k: round(v / tot, 4) for k, v in d.items()}
                            if tot else None)
    for k in _VMSTAT_KEYS + ("self_minflt", "self_majflt"):
        if k in a and k in b:
            out[k] = b[k] - a[k]
    for k in ("self_rss_kb", "self_anonhugepages_kb"):
        if k in b:
            out[k] = b[k]
    load = _text("/proc/loadavg")
    out["loadavg"] = load.split()[:3] if load else None
    return out


def probe() -> dict:
    """A fixed host workload, timed: first touch of 256 MiB of fresh
    memory, and 2^24 random gathers from a 512 MiB table that is already
    touched (the better of two each).  The same work in every run, so its
    times compare machines and moments."""
    import mmap

    rng = np.random.default_rng(0)
    table = np.ones(1 << 26, dtype=np.int64)
    idx = rng.integers(0, table.size, 1 << 24)
    touch, gather = [], []
    for _ in range(2):
        # an anonymous mapping of its own: fresh pages, whatever the
        # allocator holds
        m = mmap.mmap(-1, 1 << 28)
        t = time.perf_counter()
        np.frombuffer(m, dtype=np.int64).fill(1)
        touch.append(time.perf_counter() - t)
        m.close()
        t = time.perf_counter()
        int(table[idx].sum())
        gather.append(time.perf_counter() - t)
    return {"touch_256mib_s": round(min(touch), 4),
            "gather_16m_s": round(min(gather), 4)}
