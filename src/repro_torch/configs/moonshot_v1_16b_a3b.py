"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (kv=16) d_ff=1408 per expert, vocab=163840,
64 experts / top-6. The port's copy of ``repro.configs.moonshot_v1_16b_a3b``.
"""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1408,
    vocab=163_840,
    n_experts=64,
    experts_per_token=6,
)

SMOKE = reduced(CONFIG)
