"""RN50-W2A2 (ternary-weight ResNet-50 on Alveo U250) — paper §III/§V."""

from repro_torch.configs.accel import make_rn50

ACCEL = make_rn50(2)
