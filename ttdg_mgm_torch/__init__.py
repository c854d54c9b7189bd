"""PyTorch/CUDA port of ``ttdg_mgm_tpu`` for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package stays the reference; this package mirrors its layout
(``config.py``, ``data/``, ``ops/``, ``models/``, ``graph/``, ``solver/``,
``engine/``, ``evaluation/``, ``checkpoint/``, ``utils/``) and its public
tensor layouts (NHWC images and FPN levels, ``(B, K, 4)`` boxes), with
PyTorch modules named after the detectron2 state dict.  It imports neither
``jax`` nor anything of ``ttdg_mgm_tpu``; ``train_net_torch.py`` is its
command line.

Two hand-written CUDA kernels carry the eval-only TTA path
(``csrc/roi_pool.cu``, ``csrc/gagm.cu``).  They are compiled with ``nvcc`` at
first use, never at import, so the package imports on a machine without a
CUDA toolchain; there, every function runs its plain PyTorch version on CPU
tensors.

Entry points take a ``device`` argument that defaults to CUDA.  Without a
GPU they raise unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and
    no GPU is present -- there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ttdg_mgm_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
