"""zamba2-7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, ssm_state=64, attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128, ssm_state=16, ssm_head=16, attn_every=2,
    remat_policy="none",
)
