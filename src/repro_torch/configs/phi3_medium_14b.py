"""phi3-medium-14b — dense LM, RoPE SwiGLU GQA [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352, head dim 128,
untied embeddings. The port's copy of ``repro.configs.phi3_medium_14b``.
"""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv=10,
    d_ff=17_920,
    vocab=100_352,
)

SMOKE = reduced(CONFIG, n_heads=4, n_kv=2)
