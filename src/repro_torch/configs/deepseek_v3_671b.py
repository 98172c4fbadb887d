"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8 [arXiv:2412.19437]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280, n_experts=256, top_k=8, n_shared_experts=1,
    use_mla=True, head_dim=128,
)

SMOKE = ModelConfig(
    name="dsv3-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=128, n_experts=8, top_k=2, capacity_factor=8.0,
    n_shared_experts=1, use_mla=True, head_dim=16, remat_policy="none",
)
