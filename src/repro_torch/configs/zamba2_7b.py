"""zamba2-7b — hybrid: mamba2 backbone + ONE shared attention block applied
every 6 mamba blocks [arXiv:2411.15242; unverified]:
81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64."""
from repro_torch.models.common import Family, ModelConfig

FULL = ModelConfig(
    name="zamba2-7b", family=Family.HYBRID,
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_groups=1, ssm_chunk=256,
    attn_every=6,  # 13 shared-attn applications + 3 trailing mamba blocks
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family=Family.HYBRID,
    n_layers=5, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=256,
    ssm_state=16, ssm_headdim=32, ssm_chunk=16, attn_every=2, dtype="float32",
)
