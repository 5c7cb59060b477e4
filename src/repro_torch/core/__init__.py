"""The port's copies of the jax-free FCMP core: RAM/GPU models, buffers,
Eq. 2, the packing solvers and the weight-tile bridge."""
