"""walt_tpu_torch: the waltx bisulfite read mapper on PyTorch and CUDA.

A port of ``walt_tpu`` (the JAX package, which stays the reference) to
PyTorch tensors on an explicit device, with hand-written CUDA kernels for
NVIDIA Hopper (``csrc/``).  The host layer of ``walt_tpu`` (FASTQ parsing,
index build and I/O, emission, the native exact replay) imports no JAX and
is reused by import; this package replaces only the modules that import
JAX: ``ops/`` (packed-word ops, the verify kernel, device tables, the
strand pipeline, the single-end fold, the paired-end mate step), the
backend, ``parallel/`` (device meshes, tp-sharded tables, multi-process
runs), the CLI and ``entry`` (the one-table step and the multi-device dry
run).

Nothing here imports ``jax`` or ``walt_tpu.ops``.
"""

__version__ = "0.1.0"
