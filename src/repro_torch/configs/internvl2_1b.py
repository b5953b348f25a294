"""internvl2-1b — InternViT frontend (stubbed) + Qwen2-0.5B LM backbone
[arXiv:2404.16821; hf]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 v=151655.

14 heads do not divide the 16-way model axis: attention runs data-parallel
with replicated attention weights; the FFN/vocab stay TP-sharded
(DESIGN.md §Arch-applicability)."""
from repro_torch.models.common import Family, ModelConfig

FULL = ModelConfig(
    name="internvl2-1b", family=Family.VLM,
    n_layers=24, d_model=896, n_heads=14, n_kv=2, d_ff=4864, vocab=151655, pad_vocab_to=16,
    n_vision_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family=Family.VLM,
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
    n_vision_tokens=8, dtype="float32",
)
