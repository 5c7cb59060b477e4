"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
One *shared* attention+FFN block is applied every 6 mamba layers (9
applications of the same parameters — Zamba's weight-shared global
mixer). The port's copy of ``repro.configs.zamba2_2p7b``.
"""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_ff=10_240,
    vocab=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
)

SMOKE = reduced(CONFIG, n_layers=4, hybrid_attn_every=2)
