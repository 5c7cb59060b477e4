"""internvl2-76b — VLM: InternViT + InternLM2 backbone [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. Only the
transformer backbone is modelled; the vision frontend is a stub: the
caller supplies precomputed patch embeddings (256 patches per image tile,
InternVL's pixel-unshuffled 448x448 tile) as ``prefix_embeds``.
The port's copy of ``repro.configs.internvl2_76b``.
"""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=28_672,
    vocab=128_256,
    n_patches=256,
)

SMOKE = reduced(CONFIG)
