"""h2o-danube-1.8b — dense LM, llama+mistral mix with sliding-window
attention [arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096,
untied embeddings. Head dim 80 (2560 / 32). The port's copy of
``repro.configs.h2o_danube_1p8b``.
"""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    d_ff=6912,
    vocab=32_000,
    sliding_window=4096,
    rope_theta=10_000.0,
)

SMOKE = reduced(CONFIG)
