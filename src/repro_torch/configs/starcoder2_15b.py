"""starcoder2-15b — dense GQA kv=4, RoPE [arXiv:2402.19173]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab=128, remat_policy="none",
)
