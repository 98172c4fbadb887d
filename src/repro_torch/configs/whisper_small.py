"""whisper-small — enc-dec; conv frontend is a stub (frame embeddings in)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, mlp_style="gelu", enc_len=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128, mlp_style="gelu", enc_len=32, remat_policy="none",
)
