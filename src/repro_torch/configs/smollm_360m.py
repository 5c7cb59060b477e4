"""smollm-360m — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, head_dim=64,
tied embeddings.
"""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv=5,
    d_ff=2560,
    vocab=49_152,
    head_dim=64,
    tie_embeddings=True,
)

SMOKE = reduced(CONFIG, n_heads=3, n_kv=1)
