from repro_torch.optim.adamw import AdamW, OptState  # noqa: F401
