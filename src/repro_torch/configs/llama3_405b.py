"""llama3-405b — dense GQA 128k vocab [arXiv:2407.21783; unverified]:
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.

FSDP over 'data' + TP over 'model' (weights alone exceed TP-only HBM);
bf16 optimizer moments (DESIGN.md §6); long_500k skipped (full attention)."""
from repro_torch.models.common import Family, ModelConfig

FULL = ModelConfig(
    name="llama3-405b", family=Family.DENSE,
    n_layers=126, d_model=16384, n_heads=128, n_kv=8, d_ff=53248, vocab=128256,
    rope_theta=500000.0, fsdp=True, optim_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke", family=Family.DENSE,
    n_layers=2, d_model=128, n_heads=8, n_kv=2, d_ff=416, vocab=256,
    dtype="float32",
)
