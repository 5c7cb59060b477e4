"""mamba2-1.3b — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060].

48L d_model=2048 (attn-free, d_ff=0) vocab=50280, ssm_state=128,
head_dim=64, expand=2 (d_inner=4096, 64 SSM heads). O(1) decode state.
The port's copy of ``repro.configs.mamba2_1p3b``.
"""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=32,  # unused by the ssm family (attention-free); kept for hd math
    n_kv=32,
    d_ff=0,
    vocab=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)

SMOKE = reduced(CONFIG)
