"""PyTorch/CUDA port of the ESSR edge-selective super-resolution system.

The JAX package ``repro`` is the reference; this package mirrors its
subpackages (``models``, ``core``, ``kernels``, ``api``, ...) and never imports
``jax`` or anything of ``repro``. The serving path runs on an NVIDIA Hopper
card through hand-written CUDA kernels (``kernels/`` + ``csrc/``); every entry
point runs on the card unless the caller asks for ``device="cpu"``, where the
kernel wrappers take their plain PyTorch versions.

Layouts follow the reference at every public function: frames are NHWC
``(H, W, 3)`` in [0, 1], patch batches ``(N, p, p, C)``, weights HWIO.
"""
from repro_torch.models.essr import ESSR, ESSR_X2, ESSR_X4, ESSRConfig

__all__ = ["ESSR", "ESSRConfig", "ESSR_X2", "ESSR_X4"]
