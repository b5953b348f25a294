"""grok-1-314b — MoE 8 experts top-2 [hf:xai-org/grok-1; unverified]:
64L d_model=6144 48H (GQA kv=8) d_ff=32768/expert vocab=131072.

8 experts < 16-way model axis: each expert's FFN splits across 2 shards
(layers.moe_ff_split); weights additionally FSDP-shard over 'data'."""
from repro_torch.models.common import Family, ModelConfig

FULL = ModelConfig(
    name="grok-1-314b", family=Family.MOE,
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, capacity_factor=1.25, moe_impl="a2a",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="grok-smoke", family=Family.MOE,
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
    n_experts=4, top_k=2, moe_impl="dense", dtype="float32",
)
