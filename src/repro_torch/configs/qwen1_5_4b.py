"""qwen1.5-4b — dense GQA with QKV bias [hf:Qwen/Qwen1.5-4B]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab=151936, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128, qkv_bias=True, remat_policy="none",
)
