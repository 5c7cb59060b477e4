"""whisper-tiny — encoder-decoder audio backbone [arXiv:2212.04356].

4L (decoder) + 4L (encoder), d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
The conv frontend is a stub: the caller supplies precomputed frame
embeddings (B, 1500, d) — Whisper's 30 s / 2x-strided mel frontend yields
1500 frames. The port's copy of ``repro.configs.whisper_tiny``.
"""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51_865,
    n_enc_layers=4,
    frontend_len=1500,
)

SMOKE = reduced(CONFIG, n_heads=4, n_kv=4)
