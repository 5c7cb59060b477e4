"""The port's copies of the jax-free FCMP core: RAM, FPGA and GPU
resource models, MVAU buffers, Eq. 2 (GALS), the packing solvers, the
folding search, the dataflow pipeline model, Eq. 1 reports, the CNV and
ResNet-50 layer sets, and the weight-tile bridge."""
