"""f2nerf_tpu_torch — the PyTorch/CUDA port of f2nerf_tpu for NVIDIA Hopper.

Mirrors the JAX package's module layout (``core``, ``ops``, ``kernels``,
``models``, ``train``, ``localize``, ``apps``) so each function has a counterpart of
the same name. The port imports nothing of JAX or of ``f2nerf_tpu``: it
keeps its own copies of what it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

from f2nerf_tpu_torch.core.config import Config, ModelConfig, TrainConfig  # noqa: F401
