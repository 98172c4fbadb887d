"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 [arXiv:2501]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, n_experts=384, top_k=8, n_shared_experts=1,
)

SMOKE = ModelConfig(
    name="kimi-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=128, n_experts=8, top_k=2, capacity_factor=8.0,
    n_shared_experts=1, remat_policy="none",
)
