"""x3tpu_torch — the PyTorch and CUDA port of x3tpu.

The port imports nothing of the JAX package; it keeps its own copies of
x3tpu's framework-free modules (:mod:`x3tpu_torch.config`, the container
format :mod:`x3tpu_torch.parallel.blocks`, :mod:`x3tpu_torch.utils.stats`,
:mod:`x3tpu_torch.warm`).
Everything that ran on JAX is ported:

* :mod:`x3tpu_torch.ops`, :mod:`x3tpu_torch.models`,
  :mod:`x3tpu_torch.codec` — the lane-batched encoder and decoder in plain
  PyTorch (the port of x3tpu's XLA engine, and the plain versions of the
  CUDA kernels);
* :mod:`x3tpu_torch.vm.driver` — the CUDA encoder and decoder kernels
  (``csrc/``);
* :mod:`x3tpu_torch.parallel.runtime` — ``compress`` and ``decompress``,
  with dictionary seeds, the model warm start and the wave journal;
* :mod:`x3tpu_torch.warm` — the warm start's tape and replay rule, the
  port's copy of ``x3tpu.warm``;
* :mod:`x3tpu_torch.parallel.mesh` — lane groups over the local CUDA
  devices (``make_mesh``, ``compress(mesh=)``), each launch sized to its
  share of its card's memory;
* :mod:`x3tpu_torch.parallel.distributed` — several processes: the
  ``torch.distributed`` (gloo) bootstrap and the in-order gather of the
  payloads;
* :mod:`x3tpu_torch.host` — the seed and tape trainer
  (``csrc/x3_train.cpp``, its own copy of the JAX package's host
  codec's);
* :mod:`x3tpu_torch.cli` — ``python -m x3tpu_torch``.

Importing the package pulls in neither jax nor the kernel build.
"""

from x3tpu_torch.config import CodecCaps, X3Params

__all__ = ["X3Params", "CodecCaps", "compress", "decompress"]


def __getattr__(name):
    if name in ("compress", "decompress"):
        from x3tpu_torch.parallel import runtime

        return getattr(runtime, name)
    raise AttributeError(f"module 'x3tpu_torch' has no attribute {name!r}")
