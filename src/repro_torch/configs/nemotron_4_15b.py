"""nemotron-4-15b — dense GQA, squared-ReLU FFN [arXiv:2402.16819;
unverified]: 32L d_model=6144 48H (kv=8) d_ff=24576 vocab=256000."""
from repro_torch.models.common import Family, ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b", family=Family.DENSE,
    n_layers=32, d_model=6144, n_heads=48, n_kv=8, d_ff=24576, vocab=256000,
    act="squared_relu",
)

SMOKE = ModelConfig(
    name="nemotron-smoke", family=Family.DENSE,
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=256, vocab=256,
    act="squared_relu", dtype="float32",
)
