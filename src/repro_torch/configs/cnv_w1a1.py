"""CNV-W1A1 (BNN-Pynq, CIFAR-10 binarized CNN on Zynq 7020) — paper §V."""

from repro_torch.configs.accel import make_cnv

ACCEL = make_cnv(1)
