"""The offline-quantized linear layer and the legacy host-gather loop on
the card (no JAX here: each is held to the port's plain version).

- ``quantized_linear_apply`` on a CUDA tensor runs the W4A8 kernel over
  the layer's packed weight; it must equal the CPU plain version
  (``w4a8_matmul_ref``) within rtol 1e-6 in float32 (the f32 epilogue
  may round an element one ulp apart); a bfloat16 input gets its output
  rounded to bfloat16, where that ulp can move the rounding: one bf16
  ulp (rtol 2^-7).  The activation codes are the CPU's bit for bit: the
  quantizer's scale divides exactly on the card (``div_scalar``).
- ``serve_batch(kv_path="host")`` on the card launches the W4A8, BVQ,
  rotation and paged-attention kernels, counts its copy seconds, and its
  tokens equal the card's paged ``serve_batch`` except where a row's first
  divergence is a near-tie (the target's top-2 logits within 2e-2: the
  two paths walk a row's positions in pages of other sizes).

Run on the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_host_gather_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import prng
from repro_torch.core import quantization as q
from repro_torch.kernels import _lib
from repro_torch.launch.serve import build_pair, to_device
from repro_torch.serving import engine as E
from repro_torch.serving.batcher import BatchConfig

NEAR_TIE = 2e-2


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_quantizer_scales_divide_exactly_on_card(cuda):
    """The dynamic quantizers' ``amax / 127`` (``div_scalar``) is the CPU's
    correctly rounded quotient on the card, bit for bit, so the int8
    activation codes of a bfloat16 input (whose x / s often sits on a .5
    boundary) are the CPU's too."""
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(1 << 20, generator=gen) * 100
    assert torch.equal(q.div_scalar(a.to(cuda), 127).cpu(), a / 127)
    x = (torch.randn(64, 4096, generator=gen) * 2.0).to(torch.bfloat16)
    xq, sx = q.quantize_act_int8(x.to(cuda))
    want_q, want_s = q.quantize_act_int8(x)
    assert torch.equal(xq.cpu(), want_q) and torch.equal(sx.cpu(), want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(32, 4096, 11008), (32, 11008, 4096), (5, 344, 96)])
def test_quantized_linear_apply_on_card(cuda, m, k, n, dtype):
    gen = torch.Generator().manual_seed(k + n)
    w = torch.randn(k, n, generator=gen) * 0.05
    x = (torch.randn(m, k, generator=gen) * 2.0).to(dtype)
    ql = q.quantize_linear_weights(w)
    want = q.quantized_linear_apply(x, ql)
    card = q.QuantizedLinear(ql.wq.to(cuda), ql.sw.to(cuda), ql.bits, ql.packed.to(cuda))
    _lib.launches.clear()
    got = q.quantized_linear_apply(x.to(cuda), card)
    assert _lib.launches["w4a8_matmul"] == 1
    assert got.dtype == dtype and got.shape == want.shape
    rtol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=rtol, atol=1e-6)


def _margin(target, prompt, a, b):
    i = next(j for j in range(len(a)) if a[j] != b[j])
    seq = torch.as_tensor(np.concatenate([prompt, np.asarray(a[:i], np.int32)]),
                          device=target.device)
    logits, _ = E.make_interface(target).prefill(target.params, seq[None])
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return float(top2[0] - top2[1])


@pytest.mark.cuda
def test_host_loop_on_card(cuda):
    t_cpu, d_cpu = build_pair(seed=0, s_max=128, device="cpu")
    target, draft = to_device(t_cpu, cuda), to_device(d_cpu, cuda)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, target.cfg.vocab, size=rng.randint(3, 24)).astype(np.int32)
               for _ in range(5)]
    cfg = dict(max_batch=2, max_tokens=16)
    _lib.launches.clear()
    got, summary = E.serve_batch(prng.PRNGKey(0), target, draft, prompts,
                                 BatchConfig(kv_path="host", **cfg))
    launches = dict(_lib.launches)
    for name in ("w4a8_matmul", "bvq_matmul", "block_rotate", "paged_attention"):
        assert launches.get(name, 0) > 0, (name, launches)
    assert summary["kv_path"] == "host" and summary["kv_copy_s"] > 0.0
    want, _ = E.serve_batch(prng.PRNGKey(0), target, draft, prompts, BatchConfig(**cfg))
    for p, a, b in zip(prompts, got, want):
        a, b = a.tolist(), b.tolist()
        assert len(a) == cfg["max_tokens"]
        if a != b:
            assert _margin(target, p, a, b) <= NEAR_TIE
