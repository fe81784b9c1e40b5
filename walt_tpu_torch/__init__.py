"""walt_tpu_torch: the waltx bisulfite read mapper on PyTorch and CUDA.

A port of ``walt_tpu`` (the JAX package, which stays the reference) to
PyTorch tensors on an explicit device, with hand-written CUDA kernels for
NVIDIA Hopper (``csrc/``).  The package stands alone: it imports neither
``jax`` nor anything of ``walt_tpu``.  Its host layer (constants, genome,
index build and I/O, FASTQ parsing, emission, replay, resume, the SE and
PE drivers and the g++-built ``native/`` library) is a copy of the
reference's, byte for byte in behaviour; ``ops/`` (packed-word ops, the
verify kernels, device tables, the strand pipeline, the single-end fold,
the paired-end mate step), the backend, ``parallel/`` (device meshes,
tp-sharded tables, multi-process runs), the CLI and ``entry`` (the
one-table step and the multi-device dry run) are the port proper.
Indexes written by either package are read by both (one on-disk format).
"""

__version__ = "0.1.0"

from walt_tpu_torch.hostmem import tune_malloc as _tune_malloc

_tune_malloc()
