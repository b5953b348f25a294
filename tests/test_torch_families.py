"""The repo's decoder configurations in the port against the JAX package:
the config registry field for field, the family layers (Qwen3's per-head
qk-norm, the three MLP activations, the MoE top-k gates and dense
combine), and ``apply_lm`` on the attention-family smoke configs, with
float32 weights made by the JAX package and carried across with
``params_from_numpy``.

Tolerance: both sides compute in float32 with no quantized activation, so
logits agree to atol 1e-4 on O(1) values (summation order only).  On int8
pools the window's K/V quantize on the write: where a last-bit difference
puts a value's x/s on the other side of a .5 boundary the two sides store
codes one step apart, and each such code is snapped to the reference's
after checking that it is that flip (as tests/test_torch_tree_int8.py does
for the W4A8 activations; the count is printed).  Router
near-tie rule (MoE): XLA and torch round the router's float32 logits
differently in the last bit, so where a token's k-th and (k+1)-th router
logits lie within ROUTER_TIE in some layer, the two sides may pick
different experts; that token's row and the later rows of its sequence
(which attend to it) are excluded from the comparison and printed.  At
the seeds used here no row is excluded."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax
import jax.numpy as jnp
from test_torch_models import one_thread, to_numpy_tree  # noqa: F401
from test_torch_tree_int8 import FLIP_EPS, _map, _window_cache

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.core import costs
from repro_torch.models import common as tcommon
from repro_torch.models import convert as tconvert
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.serving import quantized_lm as tqlm
from repro_torch.serving import engine as tengine
from repro_torch.serving.engine import EngineConfig, ServingModel
from repro_torch.serving.paged_cache import device_pool_store

pytestmark = pytest.mark.usefixtures("one_thread")
ATOL = 1e-4
ROUTER_TIE = 1e-4
S_MAX = 64

# (arch, variant): the attention-family smoke configs; "padded" gives the
# VLM a vocabulary padded to 16 (the full config's pad_vocab_to)
CASES = [("qwen3-8b", None), ("nemotron-4-15b", None), ("deepseek-67b", None),
         ("internvl2-1b", None), ("internvl2-1b", "padded"), ("moonshot-v1-16b-a3b", None),
         ("grok-1-314b", None)]
IDS = [a + (f"-{v}" if v else "") for a, v in CASES]


def _cfgs(arch, variant):
    j, t = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if variant == "padded":
        j = dataclasses.replace(j, vocab=250, pad_vocab_to=16)
        t = dataclasses.replace(t, vocab=250, pad_vocab_to=16)
    return j, t


@pytest.fixture(scope="module")
def models():
    """{case id: (JAX cfg, port cfg, JAX params, port params)}, built on
    first use."""
    cache = {}

    def get(arch, variant):
        key = (arch, variant)
        if key not in cache:
            jcfg, tcfg = _cfgs(arch, variant)
            params, _ = jlm.init_lm(jax.random.PRNGKey(3), jcfg, tp=1)
            cache[key] = (jcfg, tcfg, params,
                          tqlm.params_from_numpy(to_numpy_tree(params), tcfg, "bf16", "cpu"))
        return cache[key]

    return get


def _as_dict(cfg):
    return {f.name: (v.value if isinstance(v, (jcommon.Family, tcommon.Family)) else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


def test_registry_matches_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert tconfigs.cells() == jconfigs.cells()
    assert tconfigs.cells(include_skipped=True) == jconfigs.cells(include_skipped=True)
    assert {k: dataclasses.asdict(v) for k, v in tcommon.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcommon.SHAPES.items()}
    for arch in jconfigs.ARCH_IDS:
        for get in ("get_config", "get_smoke"):
            j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
            assert _as_dict(t) == _as_dict(j), (arch, get)
            assert (t.hd, t.vocab_padded, t.is_encdec) == (j.hd, j.vocab_padded, j.is_encdec)
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b", "whisper-large-v3"])
def test_unported_families_raise(arch):
    """The recurrent and encoder-decoder families run on a dense cache (their
    parity is tests/test_torch_ssm.py and tests/test_torch_whisper.py);
    what stays unported for them is the Engine's paged pool, which raises
    naming the family, as the reference's ``apply_lm`` does."""
    cfg = tconfigs.get_smoke(arch)
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    logits, _ = tlm.apply_lm(params, cfg, torch.zeros((1, 2), dtype=torch.int32),
                             frames=torch.zeros((1, cfg.n_audio_frames, cfg.d_model)))
    assert logits.shape == (1, 2, cfg.vocab_padded)
    paged = {"page_table": torch.zeros((1, 1), dtype=torch.int32),
             "lengths": torch.zeros(1, dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match=cfg.family.value):
        tlm.apply_lm(params, cfg, torch.zeros((1, 2), dtype=torch.int32), cache=paged)


def test_qk_head_norm_matches():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    g = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    want = np.asarray(jL._qk_head_norm(jnp.asarray(x), jnp.asarray(g)))
    got = tL.qk_head_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
def test_mlp_activations_match(act):
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3-8b"), act=act)
    tcfg = dataclasses.replace(tconfigs.get_smoke("qwen3-8b"), act=act)
    params, _ = jL.mlp_init(jax.random.PRNGKey(1), jcfg)
    x = np.random.RandomState(2).randn(2, 7, jcfg.d_model).astype(np.float32)
    want = np.asarray(jL.mlp_apply(params, jnp.asarray(x), jcfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    assert set(tp) == ({"w_gate", "w_up", "w_down"} if act == "swiglu" else {"w_up", "w_down"})
    got = tL.mlp_apply(tp, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_topk_gates_match_with_ties():
    """Random logits and integer logits full of ties: the same ids in the
    same order (ties to the lower id) and the same gates."""
    rng = np.random.RandomState(3)
    for logits in (rng.randn(40, 8).astype(np.float32),
                   rng.randint(-2, 3, (40, 8)).astype(np.float32)):
        for k in (1, 2, 6):
            wg, wi = jL._topk_gates(jnp.asarray(logits), k)
            tg, ti = tL.topk_gates(torch.from_numpy(logits), k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
            np.testing.assert_allclose(tg.numpy(), np.asarray(wg), atol=1e-6)


@pytest.mark.parametrize("arch,tp", [("moonshot-v1-16b-a3b", 1), ("grok-1-314b", 1),
                                     ("grok-1-314b", 8)], ids=["moonshot", "grok", "grok-split2"])
def test_moe_apply_dense_matches(arch, tp):
    """The dense combine, also over the (E * split, d, f / split) storage
    the reference makes when experts are fewer than the model axis, which
    the port folds into (E, d, f) as it carries the weights across; 200
    token rows span two of the port's fixed row blocks."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    params, _ = jL.moe_init(jax.random.PRNGKey(4), jcfg, tp=tp)
    assert params["w_gate"].shape[0] == jcfg.n_experts * jL.moe_ff_split(jcfg, tp)
    x = np.random.RandomState(5).randn(2, 100, jcfg.d_model).astype(np.float32)
    want = np.asarray(jL.moe_apply_dense(params, jnp.asarray(x), jcfg))
    folded = tconvert.fold_expert_split({k: np.asarray(v) for k, v in params.items()},
                                    tcfg.n_experts)
    assert folded["w_gate"].shape == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
    tp_ = {k: torch.from_numpy(np.array(v)) for k, v in folded.items()}
    got = tL.moe_apply_dense(tp_, torch.from_numpy(x), tcfg).numpy()
    keep = _router_keep(x.reshape(1, -1, jcfg.d_model), [np.asarray(params["router"])], jcfg)
    np.testing.assert_allclose(got.reshape(1, -1, jcfg.d_model)[keep],
                               want.reshape(1, -1, jcfg.d_model)[keep], atol=1e-5)


def _router_margins(z, router, k):
    """(B, S) margin between the k-th and (k+1)-th router logit."""
    logits = np.sort(z.astype(np.float32) @ router, axis=-1)[..., ::-1]
    return logits[..., k - 1] - logits[..., k]


def _router_keep(z, routers, cfg):
    """(B, S) rows outside the router near-tie rule, given each MoE
    layer's router input ``z`` (one array for all layers here) or, as
    ``_router_inputs`` records them, one per layer; excluded rows are
    printed."""
    zs = z if isinstance(z, list) else [z] * len(routers)
    tie = np.zeros(zs[0].shape[:2], bool)
    for zi, r in zip(zs, routers):
        tie |= _router_margins(zi, r, cfg.top_k) < ROUTER_TIE
    keep = ~np.logical_or.accumulate(tie, axis=1)  # a tie's later rows attend to it
    if not keep.all():
        print(f"router near-ties: excluded rows {np.argwhere(~keep).tolist()}")
    return keep


class _RouterInputs:
    """The router inputs of every MoE layer of the port's forwards run
    inside the context (patched ``layers.moe_apply``)."""

    def __init__(self, monkeypatch):
        self.z = []
        orig = tL.moe_apply

        def record(p, x, cfg):
            self.z.append(x.float().numpy().copy())
            return orig(p, x, cfg)

        monkeypatch.setattr(tL, "moe_apply", record)


def _compare(got, want, cfg, tparams, rec):
    got, want = np.asarray(got), np.asarray(want)
    if cfg.family is tcommon.Family.MOE:
        routers = [lp["moe"]["router"].numpy() for lp in tparams["layers"]]
        keep = _router_keep(rec.z[-len(routers):], routers, cfg)
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, atol=ATOL)


def _record_kv(monkeypatch):
    """Every int8 KV code the reference's quantizer writes, in call order."""
    seen, quantize = [], jL._kv_quantize

    def record(x):
        q, sc = quantize(x)
        seen.append(np.asarray(q))
        return q, sc

    monkeypatch.setattr(jL, "_kv_quantize", record)
    return seen


def _snap_kv(monkeypatch, want):
    """The port's KV quantizer, its codes snapped to the reference's where
    the two differ by a checked rounding flip (one step, x/s within
    FLIP_EPS of a .5 boundary).  Returns the flips per call."""
    flips, quantize = [], tL.kv_quantize

    def snap(x):
        q, sc = quantize(x)
        ref = torch.from_numpy(want[len(flips)].copy())
        off = q != ref
        ratio = (x.float() / sc)[off]
        assert torch.all((q[off].int() - ref[off].int()).abs() == 1), "not a one-step flip"
        assert torch.all(((ratio.abs() % 1) - 0.5).abs() < FLIP_EPS), ratio
        flips.append(int(off.sum()))
        return torch.where(off, ref, q), sc

    monkeypatch.setattr(tL, "kv_quantize", snap)
    return flips


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)).astype(np.int32)


def _vision(cfg, b, seed=9):
    if not cfg.n_vision_tokens:
        return None
    return np.random.RandomState(seed).randn(b, cfg.n_vision_tokens,
                                             cfg.d_model).astype(np.float32)


@pytest.mark.parametrize("arch,variant", CASES, ids=IDS)
def test_apply_lm_no_cache_and_dense_cache(models, monkeypatch, arch, variant):
    """No cache (a VLM with its image tokens prepended), then a
    dense-cache prefill of 8 tokens (image tokens first) and a 4-token
    extend: logits and the K rows written."""
    jcfg, tcfg, jp, tp = models(arch, variant)
    rec = _RouterInputs(monkeypatch)
    toks = _tokens(tcfg, 2, 12, seed=0)
    vis = _vision(tcfg, 2)
    jv = None if vis is None else jnp.asarray(vis)
    tv = None if vis is None else torch.from_numpy(vis)
    want, _ = jlm.apply_lm(jp, jcfg, None, jnp.asarray(toks), vision_embeds=jv)
    got, _ = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks), vision_embeds=tv)
    assert got.shape == (2, 12 + tcfg.n_vision_tokens, tcfg.vocab_padded)
    _compare(got.numpy(), want, tcfg, tp, rec)
    if tcfg.vocab_padded != tcfg.vocab:
        assert bool((got[..., tcfg.vocab:] == -1e9).all())

    jc = jlm.init_cache(jcfg, 2, S_MAX)
    tc = tlm.init_cache(tcfg, 2, S_MAX, "cpu")
    for lo, hi, vj, vt in ((0, 8, jv, tv), (8, 12, None, None)):
        want, jc = jlm.apply_lm(jp, jcfg, None, jnp.asarray(toks[:, lo:hi]), cache=jc,
                                vision_embeds=vj)
        got, tc = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks[:, lo:hi]), cache=tc,
                               vision_embeds=vt)
        _compare(got.numpy(), want, tcfg, tp, rec)
        assert int(tc["length"]) == int(jc["length"])
    n = int(tc["length"])
    assert n == 12 + tcfg.n_vision_tokens
    np.testing.assert_allclose(tc["attn"]["k"][:, :, :n].numpy(),
                               np.asarray(jc["attn"]["k"])[:, :, :n], atol=ATOL)


@pytest.mark.parametrize("window", ["fp", "int8", "tree"])
@pytest.mark.parametrize("arch,variant", CASES, ids=IDS)
def test_apply_lm_paged_windows(models, monkeypatch, arch, variant, window):
    """A 4-token window over a paged pool of random committed prefixes:
    fp pools, int8 pools, and an ancestor-masked tree window (the
    reference's plain paged path, paged_impl="gather")."""
    jcfg, tcfg, jp, tp = models(arch, variant)
    rec = _RouterInputs(monkeypatch)
    cache = _window_cache(tcfg, window == "int8", window == "tree", seed=1)
    toks = _tokens(tcfg, 4, 4, seed=3)
    jcache = _map(cache, jnp.asarray)
    if window == "int8":
        seen = _record_kv(monkeypatch)
        with jax.disable_jit():  # the layer scan runs in Python, so each call records
            want, jc = jlm.apply_lm(jp, jcfg, None, jnp.asarray(toks), cache=jcache,
                                    paged_impl="gather")
        flips = _snap_kv(monkeypatch, seen)
    else:
        want, jc = jlm.apply_lm(jp, jcfg, None, jnp.asarray(toks), cache=jcache,
                                paged_impl="gather")
    tcache = _map(cache, lambda a: torch.from_numpy(np.array(a)))
    got, tcn = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks), cache=tcache)
    if window == "int8":
        assert len(flips) == len(seen)
        print(f"int8 KV rounding flips snapped per call: {flips}")
    _compare(got.numpy(), want, tcfg, tp, rec)
    np.testing.assert_array_equal(tcn["lengths"].numpy(), np.asarray(jc["lengths"]))


@pytest.mark.parametrize("arch", ["qwen3-8b", "nemotron-4-15b", "moonshot-v1-16b-a3b",
                                  "internvl2-1b"])
def test_costs_count_each_family(arch):
    """``core/costs.py`` against a hand count: the linears are every weight
    matrix a token's forward multiplies, read off the params (attention
    over n_kv kv heads, the SwiGLU or two-matrix MLP, or the router and
    every expert of the dense combine, and the head); KV bytes a token are
    K and V over the ``n_kv`` heads the store keeps."""
    cfg = tconfigs.get_smoke(arch)
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    hand = params["embed"]["head"].numel() + sum(
        t.numel() for lp in params["layers"] for grp in ("attn", "mlp", "moe")
        for name, t in lp.get(grp, {}).items() if name not in ("q_norm", "k_norm"))
    assert costs.linear_params(cfg) == hand
    if arch == "moonshot-v1-16b-a3b":  # d 64, 4 heads of 16, f 96, 8 experts, vocab 256
        attn = 64 * (4 + 2 * 4) * 16 + 4 * 16 * 64
        assert hand == 2 * (attn + 64 * 8 + 3 * 64 * 96 * 8) + 64 * 256
    model = ServingModel(cfg, params, mode="bf16", s_max=32, device="cpu")
    store = device_pool_store(tengine._pool_for(model, EngineConfig(max_batch=1), [32]), "cpu",
                              "none")
    assert costs.kv_token_bytes(store) == 2 * cfg.n_kv * cfg.hd * 4  # f32 K and V
    cost = costs.program_cost(model, store, rows=3, keys=10, kv_read=5, kv_written=3)
    assert cost["flops"] == 2.0 * hand * 3 + 4.0 * cfg.n_layers * cfg.n_heads * cfg.hd * 10
