from repro_torch.ckpt.manager import CheckpointManager, restore_resharded  # noqa: F401
