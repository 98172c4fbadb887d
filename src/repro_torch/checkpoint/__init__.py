"""Mid-chain sampler checkpoints (``sampler_state``) and the training
checkpoint store (``store``)."""
