"""Site-step kernels (CUDA for Hopper), their plain versions and the
dispatch registry."""
