"""Architecture registry of the port.

``get_config(name)`` returns the full-size ``ModelConfig``,
``get_smoke_config(name)`` the reduced same-family config the CPU tests
use. Only the archs already ported are registered; any other id raises
``ValueError`` naming them. The paper's FPGA accelerator models (CNV and
ResNet-50 as MVAU layer sets) come from ``get_accelerator(name)``; the LM
lookups refuse their ids, as the reference's do.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCH_IDS = ["smollm_360m"]

# assignment ids (dashes/dots) -> module names
ALIASES = {"smollm-360m": "smollm_360m"}


ACCEL_IDS = ["cnv_w1a1", "cnv_w2a2", "rn50_w1a2", "rn50_w2a2"]


def _canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def canonical_arch(name: str) -> str:
    """Canonical module id for an LM arch name; accelerator ids and unknown
    or not-yet-ported names raise ``ValueError`` listing the ported archs."""
    cand = _canonical(name)
    if cand in ACCEL_IDS:
        raise ValueError(
            f"{name!r} is an FPGA accelerator config, not an LM arch; "
            f"use get_accelerator(). Ported archs: {', '.join(ARCH_IDS)}"
        )
    if cand not in ARCH_IDS:
        raise ValueError(
            f"unknown or not yet ported arch {name!r}; ported archs: "
            f"{', '.join(ARCH_IDS)}"
        )
    return cand


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_arch(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_arch(name)}")
    if hasattr(mod, "SMOKE"):
        return mod.SMOKE
    return reduced(mod.CONFIG)


def get_accelerator(name: str):
    """The ``AccelConfig`` of one of the paper's accelerators."""
    cand = _canonical(name)
    if cand not in ACCEL_IDS:
        raise ValueError(
            f"{name!r} is not an accelerator config; valid accelerators: "
            f"{', '.join(ACCEL_IDS)}"
        )
    return importlib.import_module(f"repro_torch.configs.{cand}").ACCEL
