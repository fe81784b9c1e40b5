"""Mapping backends of the port.

- ``torch``: :class:`walt_tpu_torch.core.torch_backend.TorchBackend`, the
  batched device pipeline on an explicit torch device or a (dp, tp) mesh
  (``get_backend("torch", mesh=..., tp=..., tp_accel=...)``);
- ``numpy``: ``walt_tpu.core.backends.NumpyBackend``, the exact host oracle
  (it imports no JAX and is reused as it stands).
"""

from __future__ import annotations

from walt_tpu.core.backends import NumpyBackend


def get_backend(name: str, **kwargs):
    if name == "numpy":
        return NumpyBackend()
    if name == "torch":
        from walt_tpu_torch.core.torch_backend import TorchBackend

        return TorchBackend(**kwargs)
    raise ValueError(f"unknown backend {name!r}")
