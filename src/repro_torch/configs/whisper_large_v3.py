"""whisper-large-v3 — encoder-decoder, conv/mel frontend STUBBED
[arXiv:2212.04356; unverified]: 32L enc + 32L dec, d_model=1280 20H (MHA
kv=20) d_ff=5120 vocab=51866, 1500 audio frames.

20 heads do not divide the 16-way model axis: attention is data-parallel
with replicated weights; FFN/vocab TP-shard (DESIGN.md §Arch-applicability).
decode shapes lower the DECODER (self-KV cache + cross-attn onto frames)."""
from repro_torch.models.common import Family, ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3", family=Family.AUDIO,
    n_layers=32, n_encoder_layers=32, d_model=1280, n_heads=20, n_kv=20,
    d_ff=5120, vocab=51866, pad_vocab_to=16, act="gelu", n_audio_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family=Family.AUDIO,
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=256, act="gelu", n_audio_frames=16, dtype="float32",
)
