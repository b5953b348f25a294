"""The paper's own TLM/DLM serving pair (Fig. 31.1.6 system config):
LLaMA2-7B target + LLaMA-68M-class draft.  These run the W4A8+LRU (TLM)
and BVQ (DLM) serving paths in serving/quantized_lm.py."""
from repro_torch.models.common import Family, ModelConfig

TLM = ModelConfig(
    name="llama2-7b", family=Family.DENSE,
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, d_ff=11008, vocab=32000,
)

DLM = ModelConfig(
    name="llama-68m", family=Family.DENSE,
    n_layers=2, d_model=768, n_heads=12, n_kv=12, d_ff=3072, vocab=32000,
)

TLM_SMOKE = ModelConfig(
    name="llama2-7b-smoke", family=Family.DENSE,
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=344, vocab=512,
    dtype="float32",
)

DLM_SMOKE = ModelConfig(
    name="llama-68m-smoke", family=Family.DENSE,
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=512,
    dtype="float32",
)
