"""Mapping backends of the port: candidate streams for a batch against one
table.

- ``torch``: :class:`walt_tpu_torch.core.torch_backend.TorchBackend`, the
  batched device pipeline on an explicit torch device or a (dp, tp) mesh
  (``get_backend("torch", mesh=..., tp=..., tp_accel=...)``);
- ``numpy``: :class:`NumpyBackend`, exact host-side enumeration
  (walt_tpu_torch.core.refmap); the oracle, and the fallback for reads the
  device slabs cannot hold.
"""

from __future__ import annotations

import numpy as np

from walt_tpu_torch.constants import SeedPattern
from walt_tpu_torch.core import refmap
from walt_tpu_torch.genome import Genome
from walt_tpu_torch.index.build import HashTable


class NumpyBackend:
    """Exact, host-only enumeration (the executable spec)."""

    name = "numpy"

    def map_strand(self, codes: np.ndarray, lens: np.ndarray, genome: Genome,
                   table: HashTable, ag_wildcard: bool, b: int,
                   max_mismatches: int, pattern: SeedPattern) -> list:
        from walt_tpu_torch.host import replay

        seq_padded = refmap.padded_seq(genome, pattern)

        def one(i):
            return list(
                refmap.enumerate_candidates(
                    codes[i, : int(lens[i])], genome, table, ag_wildcard, b,
                    max_mismatches, pattern, seq_padded=seq_padded,
                )
            )

        return replay.host_map(one, range(codes.shape[0]))


def get_backend(name: str, **kwargs):
    if name == "numpy":
        return NumpyBackend()
    if name == "torch":
        from walt_tpu_torch.core.torch_backend import TorchBackend

        return TorchBackend(**kwargs)
    raise ValueError(f"unknown backend {name!r}")
