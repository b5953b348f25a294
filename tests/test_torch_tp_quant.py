"""The W4A8 + LRU target on its shards: ``quantized_lm.apply_quantized_lm(...,
mesh=)`` over local gloo worlds of CPU ranks at meshes (1, 2), (2, 2),
(1, 4) and (2, 1), from the JAX package's ``quantize_dense_lm`` weights
(each rank cuts its blocks of the reference's packing, then prepacks
them), the W4A8 MoE forward on its shards, and K1's int32 epilogue.

The sharded forward is the one-device port's bit for bit (logits and the
greedy tokens of a prefill and three decode steps over the dense cache),
with virtual KV heads (n_kv 2 at tp 4) and with attention replicated (6
heads at tp 4) too: the column shards' outputs are the full product's
columns, the row shards' int32 accumulators sum exactly, and their
activation codes come from the whole row's maximum.  Under FSDP each rank
keeps a ``data`` block of its prepacked tiles and gathers them before K1,
so the (2, 2) and (2, 1) outputs are one device's bit for bit too.  The
reference runs
on one intra-op thread, as the ranks do.  Against
the JAX function without a mesh: the greedy tokens equal, and the logits
within 1e-5 once each int8 activation that a rounding flip made differ is
snapped to the reference's (the repo's checked-flip rule,
``test_torch_tree_int8._snap_flips``: one step apart, at a .5 boundary)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp

import torch_mesh_cases as C
from test_torch_models import ROW_EXACT, one_thread  # noqa: F401
from test_torch_tree_int8 import _record_activations, _snap_flips
from repro import configs as jconfigs
from repro.configs import paper_pair as jpair
from repro.models import lm as jlm
from repro.serving import quantized_lm as jq
from repro_torch import configs as tconfigs
from repro_torch.configs import paper_pair as tpair
from repro_torch.core import quantization as q
from repro_torch.kernels import ref
from repro_torch.kernels.w4a8_matmul import prepack, w4a8_matmul, w4a8_matmul_int32
from repro_torch.launch import mesh as tmesh

pytestmark = pytest.mark.usefixtures("one_thread")  # the ranks' thread count: CPU GEMMs
# block their sums by the threads they run on
MESHES = [(1, 2), (2, 2), (1, 4), (2, 1)]
STEPS = 3


def _variants():
    """(name, JAX config, port config)."""
    six = {"n_heads": 6, "head_dim": 16}  # attention replicated at tp 4
    fsdp = {"fsdp": True}  # the prepacked tiles cut over data: (2, 2) and (2, 1)
    return [
        ("qwen3", jconfigs.get_smoke("qwen3-8b"), tconfigs.get_smoke("qwen3-8b")),
        ("qwen3-fsdp", C.with_fields(jconfigs.get_smoke("qwen3-8b"), **fsdp),
         C.with_fields(tconfigs.get_smoke("qwen3-8b"), **fsdp)),
        ("paper-target", jpair.TLM_SMOKE, tpair.TLM_SMOKE),
        ("six-heads", C.with_fields(jconfigs.get_smoke("qwen3-8b"), **six),
         C.with_fields(tconfigs.get_smoke("qwen3-8b"), **six)),
    ]


def _jax_greedy(jcfg, qp, tokens, steps):
    cache = jlm.init_cache(jcfg, tokens.shape[0], tokens.shape[1] + steps, tp=1)
    fwd = jax.jit(lambda p, t, c: jq.apply_quantized_lm(p, jcfg, None, t, cache=c))
    logits, cache = fwd(qp, jnp.asarray(tokens), cache)
    toks = [np.asarray(logits[:, -1]).argmax(-1)]
    for _ in range(steps - 1):
        logits, cache = fwd(qp, jnp.asarray(toks[-1][:, None]), cache)
        toks.append(np.asarray(logits[:, -1]).argmax(-1))
    return np.stack(toks, 1)


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(3)
    out = []
    for i, (name, jcfg, tcfg) in enumerate(_variants()):
        params = jax.jit(lambda k: jlm.init_lm(k, jcfg, tp=1)[0])(jax.random.PRNGKey(i))
        qp = jax.jit(lambda p: jq.quantize_dense_lm(p, jcfg))(params)
        tokens = rng.integers(0, jcfg.vocab, (4, 8)).astype(np.int32)
        logits, _ = jax.jit(lambda p, t: jq.apply_quantized_lm(p, jcfg, None, t))(
            qp, jnp.asarray(tokens))
        want = {"logits": np.asarray(logits), "tokens": _jax_greedy(jcfg, qp, tokens, STEPS)}
        case = (tcfg, jax.tree.map(np.asarray, qp), "w4a8", tokens.astype(np.int64), STEPS)
        out.append((name, case, want))
    one = C.quant_cases(tmesh.make_cpu_mesh(), [c[1] for c in out])
    return [(name, case, want, o) for (name, case, want), o in zip(out, one)]


@pytest.fixture(scope="module")
def moe_case():
    """grok-smoke's W4A8 MoE forward (4 experts: 2 a rank at tp 2, 1 at tp
    4) from the JAX package's ``quantize_moe_lm`` weights."""
    jcfg, tcfg = jconfigs.get_smoke("grok-1-314b"), tconfigs.get_smoke("grok-1-314b")
    params = jax.jit(lambda k: jlm.init_lm(k, jcfg, tp=1)[0])(jax.random.PRNGKey(9))
    qp = jax.jit(lambda p: jq.quantize_moe_lm(p, jcfg))(params)
    tokens = np.random.default_rng(9).integers(0, jcfg.vocab, (4, 8))
    return (tcfg, jax.tree.map(np.asarray, qp), "w4a8_moe", tokens, STEPS)


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def world(request, cases, moe_case):
    data, model = request.param
    return request.param, tmesh.spawn(C.quant_cases, data, model, device="cpu",
                                      args=([c[1] for c in cases] + [moe_case],))


@pytest.mark.parametrize("variant", [v[0] for v in _variants()])
def test_one_device_w4a8_matches_jax(cases, variant, monkeypatch):
    _, case, want, one = next(c for c in cases if c[0] == variant)
    cfg, tree, _, tokens, _ = case
    jcfg = next(v[1] for v in _variants() if v[0] == variant)
    seen = _record_activations(monkeypatch)
    with jax.disable_jit():  # each activation recorded
        logits, _ = jq.apply_quantized_lm(jax.tree.map(jnp.asarray, tree), jcfg, None,
                                          jnp.asarray(tokens))
    flips = _snap_flips(monkeypatch, seen)
    got = C.quant_cases(tmesh.make_cpu_mesh(), [(cfg, tree, "w4a8", tokens, 0)])[0]
    assert len(flips) == len(seen)
    np.testing.assert_allclose(got["logits"], np.asarray(logits), atol=ROW_EXACT, rtol=0)
    np.testing.assert_array_equal(one["tokens"], want["tokens"])


@pytest.mark.parametrize("variant", [v[0] for v in _variants()])
def test_sharded_w4a8_is_one_device(world, cases, variant):
    _, results = world
    i = [c[0] for c in cases].index(variant)
    _, _, want, one = cases[i]
    per_case = [r[i] for r in results]
    got = {k: C.collect(per_case, k) for k in ("logits", "step_logits", "tokens")}
    for key in ("logits", "step_logits"):
        np.testing.assert_array_equal(got[key], one[key])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_sharded_w4a8_moe_is_one_rank(world, moe_case):
    """The W4A8 MoE forward on a mesh (attention shards, ``_moe_a2a_quant``
    with K1 once per local expert) is bit for bit the same function on one
    rank (the all-to-all with every expert local) run on each data rank's
    rows: the capacity follows a rank's own token count, as the
    reference's."""
    (data, _), results = world
    cfg, tree, mode, tokens, steps = moe_case
    got = {k: C.collect([r[-1] for r in results], k)
           for k in ("logits", "step_logits", "tokens")}
    per = tokens.shape[0] // data
    ones = [C.quant_cases(tmesh.make_cpu_mesh(),
                          [(cfg, tree, mode, tokens[i * per:(i + 1) * per], steps)])[0]
            for i in range(data)]
    for key in ("logits", "step_logits", "tokens"):
        np.testing.assert_array_equal(got[key], np.concatenate([o[key] for o in ones]))


@pytest.mark.parametrize("m,k,n", [(1, 128, 64), (7, 344, 48), (33, 1376, 40), (4, 2752, 16)])
def test_int32_epilogue(m, k, n):
    """K1's int32 mode is the exact integer product; split into K blocks
    (prepacked after the cut) the blocks' accumulators sum to it, and one
    scaling in the kernel's order gives the scaled kernel's bits."""
    g = torch.Generator().manual_seed(m * k + n)
    x = torch.randn((m, k), generator=g)
    w = torch.randn((k, n), generator=g)
    xq, sx = q.quantize_act_int8(x)
    wq, sw = q.quantize_weight_int(w, bits=4, axis=0)
    wp = q.pack_int4(wq, axis=0)
    acc = w4a8_matmul_int32(xq, prepack(wp), n)
    assert acc.dtype == torch.int32
    exact = xq.long() @ wq.long()
    assert torch.equal(acc.long(), exact)
    assert torch.equal(ref.w4a8_matmul_int32_ref(xq, wp), acc)
    scaled = w4a8_matmul(xq, prepack(wp), sx, sw)
    assert torch.equal((acc.float() * sx) * sw, scaled)
    for tp in (2, 4):
        kb = k // tp
        if kb % 2:
            continue
        parts = [w4a8_matmul_int32(xq[:, r * kb:(r + 1) * kb].contiguous(),
                                   prepack(wp[r * kb // 2:(r + 1) * kb // 2]), n)
                 for r in range(tp)]
        assert torch.equal(sum(parts), acc)
        amax = torch.stack([x[:, r * kb:(r + 1) * kb].abs().amax(-1, keepdim=True)
                            for r in range(tp)]).amax(0)
        for r in range(tp):
            xr, sr = q.quantize_act_int8(x[:, r * kb:(r + 1) * kb], amax=amax)
            assert torch.equal(xr, xq[:, r * kb:(r + 1) * kb]) and torch.equal(sr, sx)
