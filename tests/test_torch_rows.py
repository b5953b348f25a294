"""Row bits independent of the row count: the torch ops of the serving
forwards around the kernels, at the paper pair's widths.

The engine computes the same token row at different row counts M: a
one-token draft step (M = batch), a verify window (M = batch x window), a
prefill (M = prompt length) or a prefix hit's tail extend (M = tail
length).  A lossless speculative decode needs each row's bits to be the
same at every M, or a near-tie argmax can part between the step and the
verify (or a prefix hit from its cache-off twin).  Each op runs on one
seeded 160-row input in consecutive calls of M rows and must give exactly
the bits of one call over all 160 rows.  A last-bit change in a norm's
f32 row mean moves a bf16 output element only now and then, so every row
is checked, not only the first M.  The kernels carry their own such gates
(tests/test_torch_kernels.py, tests/test_torch_attn_kernels.py); this file
holds the plain torch ops, and ``flash_attention``, which runs K8 on the
card (kernels/prefill_attn.py), at the paper pair's and the serving
cells' geometry.

The CPU cases run anywhere; the ``cuda`` cases on a GPU machine, where a
reduction or a GEMM picks its launch shape from the number of rows (on an
H100 a plain torch.mean over d = 4096 and the prefill attention's f32
GEMMs at 7-15 rows both did: models/layers.row_mean_sq, flash_attention
and linear are built against it)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quantization as q
from repro_torch.models import layers as L
from repro_torch.serving import quantized_lm as qlm

ROWS = (1, 3, 4, 8, 24, 56, 160)
D, D_FF, D_DRAFT, HEADS, HD = 4096, 11008, 768, 32, 128
S_CELL, KV_CELL = 4112, 8  # the serving cells' dense prefill cache: slots, kv heads


def _x(dev, shape, seed=0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(a).to(dev).to(torch.bfloat16)


# name -> (each row input's shape per row, None: the row's position from
#          40, an int: from that position; each fixed input's shape (seeded,
#          shared by every call); op over the row inputs, then the fixed ones)
OPS = {
    "row_mean_sq_d4096": (((D,),), (), lambda x: L.row_mean_sq(x.float())),
    "row_mean_sq_d768": (((D_DRAFT,),), (), lambda x: L.row_mean_sq(x.float())),
    "norm_only_d4096": (((D,),), (), lambda x: qlm._norm_only(x)),
    "rmsnorm_d4096": (((D,),), ((D,),), lambda x, g: L.rmsnorm({"g": 1.0 + 0.01 * g}, x)),
    "rmsnorm_d768": (((D_DRAFT,),), ((D_DRAFT,),),
                     lambda x, g: L.rmsnorm({"g": 1.0 + 0.01 * g}, x)),
    "quantize_act_int8_d4096": (((D,),), (), lambda x: torch.cat(
        [a.float().reshape(x.shape[0], -1) for a in q.quantize_act_int8(x)], -1)),
    "quantize_act_int8_d11008": (((D_FF,),), (), lambda x: torch.cat(
        [a.float().reshape(x.shape[0], -1) for a in q.quantize_act_int8(x)], -1)),
    "rope_32x128": (((HEADS, HD), None), (), lambda x, p: L.rope(x[None], p[None], 10000.0)[0]),
    "silu_mul_d11008": (((D_FF,), (D_FF,)), (), lambda g, u: L.silu_mul(g, u, torch.bfloat16)),
    "kv_quantize_32x128": (((HEADS, HD),), (), lambda x: torch.cat(
        [a.float().reshape(x.shape[0], -1) for a in L.kv_quantize(x)], -1)),
    # the dense pair's linears, bf16 cuBLAS on the card, at the w_gate shape
    "linear_d4096": (((D,),), ((D, D_FF),), lambda x, w: L.linear(x, w)),
    # prefill attention of each row (at its position) over one dense K / V
    # cache of the paper pair's s_max = 256 positions
    "flash_attention_32x128": (((HEADS, HD), None), ((1, 256, HEADS, HD), (1, 256, HEADS, HD)),
                               lambda x, p, k, v: L.flash_attention(
                                   x[None], k, v, causal=True, q_offset=int(p[0]))[0]),
}
# the serving cells' prefill attention: GQA 32/8 (Qwen3-8B) and 48/8
# (Nemotron-4-15B) at hd 128 over the 4,112-slot dense cache, rows near 1k
# and 3k
for _h in (32, 48):
    for _first in (1000, 2990):
        OPS[f"flash_attention_{_h}x{KV_CELL}x128_at{_first}"] = (
            ((_h, HD), _first), ((1, S_CELL, KV_CELL, HD), (1, S_CELL, KV_CELL, HD)),
            lambda x, p, k, v: L.flash_attention(x[None], k, v, causal=True,
                                                 q_offset=int(p[0]))[0])
# row counts of the CPU runs where ROWS would take minutes: the plain
# version pads every call to 128 rows and walks all 4,112 slots
CPU_ROWS = {name: (1, 4, 16) for name in OPS if name.endswith(("at1000", "at2990"))}


def _check(dev, name, rows=ROWS):
    shapes, fixed_shapes, op = OPS[name]
    n = rows[-1]
    ins = [(40 if s is None else s) + torch.arange(n, device=dev)
           if s is None or isinstance(s, int) else _x(dev, (n,) + s, seed=i)
           for i, s in enumerate(shapes)]
    fixed = [_x(dev, s, seed=20 + i) for i, s in enumerate(fixed_shapes)]
    full = op(*ins, *fixed)
    bad = [m for m in rows
           if not torch.equal(torch.cat([op(*(a[j:j + m] for a in ins), *fixed)
                                         for j in range(0, n, m)]), full)]
    assert not bad, f"{name}: rows differ from the same rows among {n} at M = {bad}"


@pytest.mark.parametrize("name", sorted(OPS))
def test_rows_independent_of_row_count_cpu(name):
    _check("cpu", name, CPU_ROWS.get(name, ROWS))


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPS))
def test_rows_independent_of_row_count_cuda(cuda, name):
    _check(cuda, name)
