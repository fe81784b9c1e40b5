"""Index state carried across from the JAX package.

The index is this system's state.  On disk both packages share one format
(``index/io_walt``), so an index that ``walt_tpu`` wrote is read here as it
is.  In memory, a ``walt_tpu`` ``Genome`` or ``HashTable`` is handed over as
its fields, numpy arrays, and these functions make the port's types of
them, with the dtypes the port's code expects and no copy where the input
already has them.
"""

from __future__ import annotations

import numpy as np

from walt_tpu_torch.genome import Genome
from walt_tpu_torch.index.build import HashTable


def genome_from_arrays(names, lengths, start_index, seq,
                       strand: str = "+") -> Genome:
    """A :class:`Genome` from its fields: chromosome ``names``, ``lengths``
    (n_chroms,), ``start_index`` (n_chroms + 1,) and the base codes ``seq``
    (length_of_genome,) uint8; ``strand`` "+" or "-" (a converted table's
    genome)."""
    lengths = np.asarray(lengths, dtype=np.uint32)
    start_index = np.asarray(start_index, dtype=np.uint32)
    seq = np.asarray(seq, dtype=np.uint8)
    names = [str(n) for n in names]
    if start_index.shape != (len(names) + 1,) or lengths.shape != (len(names),):
        raise ValueError(f"genome_from_arrays: {len(names)} names, "
                         f"{lengths.shape[0]} lengths, "
                         f"{start_index.shape[0]} start offsets")
    if int(start_index[-1]) != seq.shape[0]:
        raise ValueError(f"genome_from_arrays: start_index ends at "
                         f"{int(start_index[-1])}, seq holds {seq.shape[0]}")
    if strand not in ("+", "-"):
        raise ValueError(f"genome_from_arrays: strand {strand!r}")
    return Genome(names=names, lengths=lengths, start_index=start_index,
                  seq=seq, strand=strand)


def table_from_arrays(counter, index) -> HashTable:
    """A :class:`HashTable` from its CSR fields: ``counter`` (n_buckets + 1,)
    offsets and ``index`` (n,) genome positions, both u32."""
    counter = np.asarray(counter, dtype=np.uint32)
    index = np.asarray(index, dtype=np.uint32)
    if counter.ndim != 1 or index.ndim != 1 or counter.shape[0] < 2:
        raise ValueError("table_from_arrays: counter and index must be 1-D")
    if int(counter[-1]) != index.shape[0]:
        raise ValueError(f"table_from_arrays: counter ends at "
                         f"{int(counter[-1])}, index holds {index.shape[0]}")
    return HashTable(counter=counter, index=index)
