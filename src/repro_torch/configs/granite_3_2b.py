"""granite-3-2b — dense GQA kv=8 [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab=128, remat_policy="none",
)
