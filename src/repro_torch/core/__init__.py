"""Chain sampler core: PRNG, MPS container, precision, the walk."""
