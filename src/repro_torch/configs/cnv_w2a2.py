"""CNV-W2A2 (BNN-Pynq, CIFAR-10 ternary CNN on Zynq 7020) — paper §V."""

from repro_torch.configs.accel import make_cnv

ACCEL = make_cnv(2)
