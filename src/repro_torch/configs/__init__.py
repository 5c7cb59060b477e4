"""Architecture registry of the port.

``get_config(name)`` returns the full-size ``ModelConfig``,
``get_smoke_config(name)`` the reduced same-family config the CPU tests
use. Every arch of the reference is registered; any other id raises
``ValueError`` naming them; ``all_configs()`` maps each arch to its
full-size config. The paper's FPGA accelerator models (CNV and ResNet-50
as MVAU layer sets) come from ``get_accelerator(name)``; the LM lookups
refuse their ids, as the reference's do.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

# the reference's archs, in its order
ARCH_IDS = [
    "h2o_danube_1p8b",
    "llama3p2_1b",
    "phi3_medium_14b",
    "smollm_360m",
    "internvl2_76b",
    "whisper_tiny",
    "olmoe_1b_7b",
    "moonshot_v1_16b_a3b",
    "zamba2_2p7b",
    "mamba2_1p3b",
]

# assignment ids (dashes/dots) -> module names
ALIASES = {
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "llama3.2-1b": "llama3p2_1b",
    "phi3-medium-14b": "phi3_medium_14b",
    "smollm-360m": "smollm_360m",
    "internvl2-76b": "internvl2_76b",
    "whisper-tiny": "whisper_tiny",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "zamba2-2.7b": "zamba2_2p7b",
    "mamba2-1.3b": "mamba2_1p3b",
}


ACCEL_IDS = ["cnv_w1a1", "cnv_w2a2", "rn50_w1a2", "rn50_w2a2"]


def canonical(name: str) -> str:
    """Canonical module id for an arch or an accelerator name; an unknown
    name raises ``ValueError`` listing the valid ids, so every
    ``--arch``-taking entry point fails cleanly."""
    cand = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if cand not in ARCH_IDS and cand not in ACCEL_IDS:
        raise ValueError(
            f"unknown arch {name!r}; ported archs: "
            f"{', '.join(ARCH_IDS)}; accelerators: {', '.join(ACCEL_IDS)}"
        )
    return cand


def canonical_arch(name: str) -> str:
    """``canonical`` restricted to LM archs (what ``--arch`` entry points take)."""
    cand = canonical(name)
    if cand in ACCEL_IDS:
        raise ValueError(
            f"{name!r} is an FPGA accelerator config, not an LM arch; "
            f"use get_accelerator(). Ported archs: {', '.join(ARCH_IDS)}"
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
    cand = canonical(name)
    if cand not in ACCEL_IDS:
        raise ValueError(
            f"{name!r} is not an accelerator config; valid accelerators: "
            f"{', '.join(ACCEL_IDS)}"
        )
    return importlib.import_module(f"repro_torch.configs.{cand}").ACCEL


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
