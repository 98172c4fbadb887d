"""deepseek-7b — dense llama-arch [arXiv:2401.02954]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400,
)

SMOKE = ModelConfig(
    name="deepseek7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128, remat_policy="none",
)
