"""x3tpu_torch — the PyTorch and CUDA port of x3tpu.

The framework-free parts of x3tpu (``x3tpu.config``, the container format
``x3tpu.parallel.blocks``, ``x3tpu.utils.stats``) are imported as they are;
everything that ran on JAX is ported:

* :mod:`x3tpu_torch.ops`, :mod:`x3tpu_torch.models`,
  :mod:`x3tpu_torch.codec` — the lane-batched encoder in plain PyTorch (the
  port of x3tpu's XLA engine, and the plain version of the CUDA kernel);
* :mod:`x3tpu_torch.vm.driver` — the CUDA encoder kernel (``csrc/``);
* :mod:`x3tpu_torch.parallel.runtime` — ``compress``.

Importing the package pulls in neither jax nor the kernel build.
"""

from x3tpu.config import CodecCaps, X3Params

__all__ = ["X3Params", "CodecCaps", "compress"]


def __getattr__(name):
    if name == "compress":
        from x3tpu_torch.parallel import runtime

        return runtime.compress
    raise AttributeError(f"module 'x3tpu_torch' has no attribute {name!r}")
