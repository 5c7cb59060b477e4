"""llama3.2-1b — small llama3 dense LM [hf:meta-llama/Llama-3.2-1B].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, head_dim=64,
tied embeddings (as in the released model), rope_theta=500000. The port's
copy of ``repro.configs.llama3p2_1b``: like the reference it leaves out the
released model's "llama3" ``rope_scaling`` and applies plain RoPE.
"""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv=8,
    d_ff=8192,
    vocab=128_256,
    head_dim=64,
    tie_embeddings=True,
    rope_theta=500_000.0,
)

SMOKE = reduced(CONFIG)
