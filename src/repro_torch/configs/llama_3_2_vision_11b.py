"""llama-3.2-vision-11b — dense + cross-attn image layers (stub frontend)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, cross_attn_every=5, n_patches=1600,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=128, cross_attn_every=2, n_patches=16,
    remat_policy="none",
)
