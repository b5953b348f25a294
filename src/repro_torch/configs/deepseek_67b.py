"""deepseek-67b — dense llama-arch [arXiv:2401.02954; hf]:
95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.

d_ff = 22016 = 2^9 * 43 has no constructible small Hadamard factor: the LRU
uses the generic tiled plan (m=8, k=6, B=512)."""
from repro_torch.models.common import Family, ModelConfig

FULL = ModelConfig(
    name="deepseek-67b", family=Family.DENSE,
    n_layers=95, d_model=8192, n_heads=64, n_kv=8, d_ff=22016, vocab=102400,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family=Family.DENSE,
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=172, vocab=256,
    dtype="float32",
)
