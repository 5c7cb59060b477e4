"""PyTorch/CUDA port of the ``repro`` serving path.

Laid out module for module like ``src/repro/`` (``configs``, ``models``,
``kernels``, ``quant``, ``runtime``, ``launch``). The package imports
``torch`` and numpy only: never ``jax`` and never a module of ``repro``;
what it needs from the reference's jax-free modules it keeps as its own
copies. Entry points run on CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Asking for CUDA (explicitly or by default) on a machine
    without a GPU raises; nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run the plain PyTorch versions on the CPU"
        )
    return dev
