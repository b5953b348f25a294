"""qwen3-8b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B; hf]:
36L d_model=4096 32H (kv=8) d_ff=12288 vocab=151936."""
from repro_torch.models.common import Family, ModelConfig

FULL = ModelConfig(
    name="qwen3-8b", family=Family.DENSE,
    n_layers=36, d_model=4096, n_heads=32, n_kv=8, d_ff=12288, vocab=151936,
    qk_norm=True, rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family=Family.DENSE,
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
    qk_norm=True, dtype="float32",
)
