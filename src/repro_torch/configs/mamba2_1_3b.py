"""mamba2-1.3b — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]: 48L d_model=2048 vocab=50280 ssm_state=128."""
from repro_torch.models.common import Family, ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b", family=Family.SSM,
    n_layers=48, d_model=2048, n_heads=32, n_kv=32,  # attn fields unused
    d_ff=0, vocab=50280, pad_vocab_to=16,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_groups=1, ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family=Family.SSM,
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=0, vocab=256,
    ssm_state=16, ssm_headdim=32, ssm_expand=2, ssm_groups=1, ssm_chunk=16,
    dtype="float32",
)
