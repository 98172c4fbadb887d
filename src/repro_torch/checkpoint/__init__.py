"""Mid-chain sampler checkpoints (``sampler_state``)."""
