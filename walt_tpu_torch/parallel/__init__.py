"""Multi-device mapping: device meshes, sharded tables, multi-process runs.

Port of ``walt_tpu/parallel``.  The reference's only parallelism is an
OpenMP parallel-for over the reads of a batch (src/walt/mapping.cpp:494,
src/walt/paired.cpp:664); here it is a 2-D mesh of torch devices:

- ``dp`` (data parallel): read batches split across devices;
- ``tp`` (table parallel): the CSR hash table split into bucket ranges of
  about equal entry counts, so that every device-local table stays below
  2^31 entries and within one device's memory (an hg19 table holds 3.09e9
  entries), and each shard owns about 1/tp of a chunk's (read, seed)
  pairs.

``multihost`` spreads read files over processes (``torch.distributed``).
"""

from walt_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    ShardedTables,
    make_mesh,
    map_mate_sharded,
    map_single_end_sharded,
    map_strand_sharded,
    merge_gathered,
    shard_and_place,
    shard_device_table,
)
