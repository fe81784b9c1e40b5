"""Batch-granular checkpoint / resume (extension; the reference has none).

The reference appends output batch-by-batch but truncates everything at
startup (walt.cpp:229-233), so a crashed multi-hour run restarts from zero —
SURVEY.md §5 flags batch-granular resume as the natural fix.  After every
completed batch the driver writes a sidecar JSON ``<output>.waltx_ckpt[tag]``
recording how many reads were consumed, the byte length of every output
stream, and the running statistics.  ``--resume`` restores that state:
each output file is truncated back to its recorded length (dropping any torn
batch from the crash), the consumed reads are skipped with the loader's
exact line cadence, and mapping continues.  A finished run is marked
``done`` and skipped entirely on re-invocation.

Output remains byte-identical to a non-resumed run: checkpoints cut only at
batch boundaries, and read N-randomization is per-batch (srand(0),
mapping.cpp:73), so a resumed batch consumes the same rand() stream.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


def skip_reads(lines, n_reads: int) -> None:
    """Consume exactly ``n_reads`` FASTQ records from a FgetsLines stream.

    Mirrors the loader's cadence (mapping.cpp:75-81): one record is four
    non-empty logical fgets lines; empty logical lines are skipped without
    advancing.
    """
    need = 4 * n_reads
    while need > 0:
        raw = lines.next_line()
        if raw is None:
            return
        if len(raw[:-1]) == 0:
            continue
        need -= 1


def _stat_to_dict(stat) -> dict:
    d = dataclasses.asdict(stat)
    if d.get("frag_len_count") is not None:
        d["frag_len_count"] = stat.frag_len_count.tolist()
    return d


def _stat_from_dict(stat, d: dict) -> None:
    for k, v in d.items():
        if k in ("mate1", "mate2"):
            _stat_from_dict(getattr(stat, k), v)
        elif k == "frag_len_count":
            if v is not None:
                stat.frag_len_count = np.asarray(v, dtype=np.int64)
        else:
            setattr(stat, k, v)


class Checkpoint:
    """Sidecar state for one (inputs -> output) mapping run."""

    def __init__(self, output_file: str, inputs: list, tag: str = ""):
        self.path = f"{output_file}.waltx_ckpt{tag}"
        self.inputs = list(inputs)
        self.reads_done = 0
        self.done = False
        self._sizes = {}
        self._stat = None

    # -- restore ----------------------------------------------------------
    def load(self) -> bool:
        """True if a matching sidecar exists (state loaded)."""
        try:
            with open(self.path) as f:
                d = json.load(f)
        except (OSError, ValueError):
            return False
        if d.get("inputs") != self.inputs:
            return False
        self.reads_done = int(d.get("reads_done", 0))
        self.done = bool(d.get("done", False))
        self._sizes = dict(d.get("sizes", {}))
        self._stat = d.get("stat")
        return True

    def restore(self, stat, files: dict) -> None:
        """Truncate outputs to the recorded lengths and restore stats.

        ``files``: {path: file-like opened 'a'} — a path absent from the
        recorded sizes is truncated to 0 (it did not exist at checkpoint).
        """
        if self._stat is not None:
            _stat_from_dict(stat, self._stat)
        for path, f in files.items():
            if f is None:
                continue
            f.flush()
            size = int(self._sizes.get(path, 0))
            os.truncate(path, min(size, os.path.getsize(path)))
            f.seek(0, os.SEEK_END)

    # -- save --------------------------------------------------------------
    def save(self, stat, files: dict, reads_done: int,
             done: bool = False) -> None:
        sizes = {}
        for path, f in files.items():
            if f is None:
                continue
            f.flush()
            sizes[path] = f.tell()
        self.reads_done = reads_done
        self.done = done
        state = dict(
            inputs=self.inputs,
            reads_done=reads_done,
            done=done,
            sizes=sizes,
            stat=_stat_to_dict(stat),
        )
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.path)

    def stat_dict(self):
        return self._stat

    def clear(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass
