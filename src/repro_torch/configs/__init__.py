"""Architecture registry of the port.

``get_config(name)`` returns the full-size ``ModelConfig``,
``get_smoke_config(name)`` the reduced same-family config the CPU tests
use. Only the archs already ported are registered; any other id raises
``ValueError`` naming them.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCH_IDS = ["smollm_360m"]

# assignment ids (dashes/dots) -> module names
ALIASES = {"smollm-360m": "smollm_360m"}


def canonical_arch(name: str) -> str:
    """Canonical module id for an LM arch name; unknown or not-yet-ported
    names raise ``ValueError`` listing the ported archs."""
    cand = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
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
