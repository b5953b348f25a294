"""moonshot-v1-16b-a3b (Moonlight) — MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]:
48L d_model=2048 16H (kv=16) d_ff=1408/expert vocab=163840."""
from repro_torch.models.common import Family, ModelConfig

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b", family=Family.MOE,
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=163840,
    n_experts=64, top_k=6, capacity_factor=1.25, moe_impl="a2a",
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family=Family.MOE,
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=96, vocab=256,
    n_experts=8, top_k=2, moe_impl="dense", dtype="float32",
)
