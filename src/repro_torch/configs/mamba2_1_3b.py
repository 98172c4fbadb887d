"""mamba2-1.3b — attention-free SSD [arXiv:2405.21060]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280, ssm_state=128,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=128, ssm_state=16, ssm_head=16, remat_policy="none",
)
