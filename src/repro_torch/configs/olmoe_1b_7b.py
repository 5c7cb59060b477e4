"""olmoe-1b-7b — MoE LM, 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (kv=16, i.e. MHA) d_ff=1024 per expert,
vocab=50304, 64 experts / top-8. The port's copy of
``repro.configs.olmoe_1b_7b``: its many small (2048x1024) expert FFNs are
the LM's closest analogue to the paper's "many oddly-shaped parameter
buffers", the residency planner's best-fit family.
"""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1024,
    vocab=50_304,
    n_experts=64,
    experts_per_token=8,
)

SMOKE = reduced(CONFIG)
