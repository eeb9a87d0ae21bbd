"""``ray_tpu_torch`` — the PyTorch/CUDA port of ray_tpu's model layer.

The JAX package ``ray_tpu`` is the reference; every module here mirrors a
module there, by name and layout, so each function can be held against its
JAX counterpart on the same weights and inputs.  This package imports
``torch`` and never ``jax`` or anything of ``ray_tpu``.

The port's kernels are CUDA C++ for Hopper (``csrc/*.cu``), built on first
use by ``ops/_build.py``.  On CPU tensors every op runs its plain PyTorch
version instead, which is what the CPU tests exercise.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no device asked for they raise
(``device.resolve_device``).
"""

from .device import resolve_device  # noqa: F401
