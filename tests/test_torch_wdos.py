"""Adaptive APSD draft lengths and fused WDOS rounds (chain) in the port,
against the JAX package on the quantized smoke pair (W4A8 target, BVQ
draft) carried across with params_from_numpy.

- engine: staggered admission (one request per ``step()``, as
  tests/test_par_mode.py drives it), 4 requests of 24 tokens at
  max_batch=4, page_size=8: two-phase rounds under ``adaptive`` (greedy;
  requests 0 and 2 sampled), and ``par_mode="wdos"`` chain rounds, adaptive
  and at a fixed ``draft_len=3``, greedy and sampled, and adaptive with the
  target drafting for itself (requests 0 and 2 sampled).  Each case holds the
  port to the JAX Engine on tokens, ``rounds``, ``steps``, the integer
  ``fused`` fields and every request's round ``history``.  A WDOS engine's
  masked rows get NaN logits, so a caller that read one would fail; its
  tokens must also equal the port's own two-phase tokens, in strictly
  fewer rounds;
- ``forward_cache_ctx`` with a role mask against the JAX function: masked
  rows touch only the scratch page, and the other rows' logits are bitwise
  those of the same rows run alone;
- admission under ``adaptive`` reserves ``prompt + max_tokens + long_dl``
  positions, where the JAX engine does.

Mixed-KV and tree WDOS engines and stop strings under WDOS are held in
tests/test_torch_wdos_tree.py.  Tolerance: none, streams must be equal
token for token (see tests/test_torch_sampled_engine.py for why no
decision of these seeds lies at a tie)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

import jax.numpy as jnp  # noqa: E402
from test_torch_models import one_thread, to_numpy_tree  # noqa: E402,F401

from repro.launch.serve import build_pair as jax_build_pair  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.configs.paper_pair import DLM_SMOKE, TLM_SMOKE  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving import quantized_lm as tqlm  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")
S_MAX = 128
MAX_TOKENS = 24
FUSED_KEYS = ("slots", "fused_slots", "draft_row_slots", "verify_row_slots")


@pytest.fixture(scope="module")
def pairs():
    """(JAX pair, port pair on the CPU) built once."""
    jt, jd = jax_build_pair(seed=0, s_max=S_MAX, quantize=True)
    tt = ServingModel(TLM_SMOKE, tqlm.params_from_numpy(to_numpy_tree(jt.params), TLM_SMOKE,
                                                       "w4a8", "cpu"),
                      mode="w4a8", s_max=S_MAX, device="cpu")
    td = ServingModel(DLM_SMOKE, tqlm.params_from_numpy(to_numpy_tree(jd.params), DLM_SMOKE,
                                                       "bvq", "cpu"),
                      mode="bvq", s_max=S_MAX, device="cpu")
    return (jt, jd), (tt, td)


def staggered_prompts(n=4, seed=6, vocab=512):
    """tests/test_par_mode.py's prompts: 2-6 tokens each."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(2, 7)).astype(np.int32) for _ in range(n)]


def sampling(cls, sampled=(), kinds=None, **kw):
    """Four requests of MAX_TOKENS: those in ``sampled`` at temperature 0.8,
    top-k 50, top-p 0.95 with their own seeds, the others greedy;
    ``kinds`` pins each request's KV storage."""
    kinds = kinds or [None] * 4
    return [cls(max_tokens=MAX_TOKENS, kv_quant=kinds[i], **kw,
                **(dict(temperature=0.8, top_k=50, top_p=0.95, seed=11 + i) if i in sampled
                   else {}))
            for i in range(4)]


def poison_masked(eng):
    """Give every row a role mask leaves out NaN logits, on the target's
    and the draft's side of a WDOS slot: a caller that read one would
    commit a wrong token (greedy) or fail (sampled)."""

    def poisoned(step):
        def run(*args, role_mask=None):
            out = step(*args, role_mask=role_mask)
            return out if role_mask is None else out.masked_fill(~role_mask[:, None, None],
                                                                 float("nan"))
        return run

    eng._t_step, eng._d_step = poisoned(eng._t_step), poisoned(eng._d_step)
    return eng


def drive_staggered(eng, prompts, sps):
    """Admit one request per ``step()``, then drain; the run's tokens,
    rounds, steps, integer fused fields and round histories."""
    rids = []
    for p, sp in zip(prompts, sps):
        rids.append(eng.add_request(p, sp))
        eng.step()
    while eng.has_unfinished():
        eng.step()
    s = eng.summary()
    return {
        "tokens": [np.asarray(eng.output_tokens(r)).tolist() for r in rids],
        "rounds": s["rounds"],
        "steps": s["steps"],
        "fused": {k: s["fused"][k] for k in FUSED_KEYS} if "fused" in s else None,
        "history": [[tuple(int(x) for x in h) for h in eng.request(r).history] for r in rids],
    }


def models(pairs, self_draft=False):
    """The pairs, or with ``self_draft`` each package's target drafting for
    itself: the random-weight draft's proposals are almost never accepted,
    so only a self-draft moves the APSD controllers to PAR (long_dl
    windows) and makes a wrong draft token show in the tokens."""
    (jt, jd), (tt, td) = pairs
    return ((jt, jt), (tt, tt)) if self_draft else ((jt, jd), (tt, td))


def run_both(pairs, cfg, sampled=(), kinds=None, self_draft=False):
    """The staggered workload through the JAX Engine and the port's (its
    masked rows poisoned); both results."""
    (jt, jd), (tt, td) = models(pairs, self_draft)
    prompts = staggered_prompts()
    want = drive_staggered(JaxEngine(jt, jd, JaxEngineConfig(max_batch=4, page_size=8, **cfg)),
                           prompts, sampling(JaxSamplingParams, sampled, kinds))
    eng = poison_masked(Engine(tt, td, EngineConfig(max_batch=4, page_size=8, **cfg),
                               device="cpu"))
    got = drive_staggered(eng, prompts, sampling(SamplingParams, sampled, kinds))
    return want, got


def check_wdos_against_off(pairs, cfg, got, sampled=(), kinds=None, self_draft=False):
    """The port's WDOS tokens equal its own two-phase tokens, in strictly
    fewer rounds."""
    _, (tt, td) = models(pairs, self_draft)
    off_cfg = dict(cfg, par_mode="off", max_batch=4, page_size=8)
    off = drive_staggered(Engine(tt, td, EngineConfig(**off_cfg), device="cpu"),
                          staggered_prompts(), sampling(SamplingParams, sampled, kinds))
    assert got["tokens"] == off["tokens"]
    assert got["rounds"] < off["rounds"], (got["rounds"], off["rounds"])


ADAPTIVE, WDOS = dict(adaptive=True), dict(adaptive=True, par_mode="wdos")
CHAIN_CASES = {  # (config, sampled requests, self-draft)
    "adaptive-off-greedy": (ADAPTIVE, (), False),
    "adaptive-off-sampled": (ADAPTIVE, (0, 2), False),
    "wdos-adaptive-greedy": (WDOS, (), False),
    "wdos-adaptive-sampled": (WDOS, (0, 2), False),
    "wdos-fixed3-greedy": (dict(draft_len=3, par_mode="wdos"), (), False),
    "wdos-fixed3-sampled": (dict(draft_len=3, par_mode="wdos"), (0, 2), False),
    "wdos-adaptive-selfdraft-sampled": (WDOS, (0, 2), True),
}


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chain_engine_matches_jax(pairs, case):
    cfg, sampled, self_draft = CHAIN_CASES[case]
    want, got = run_both(pairs, cfg, sampled, self_draft=self_draft)
    assert got == want
    assert all(len(t) == MAX_TOKENS for t in got["tokens"])
    assert all(len(h) > 0 for h in got["history"])
    if self_draft:  # the controllers reached PAR: long_dl windows ran
        assert any(h[0] == 1 and h[1] == 6 for hist in got["history"] for h in hist)
    if cfg.get("par_mode") == "wdos":
        check_wdos_against_off(pairs, cfg, got, sampled, self_draft=self_draft)
        assert got["fused"]["fused_slots"] > 0  # one row verified while another drafted
    else:
        assert got["fused"] is None


@pytest.mark.parametrize("model", ["target", "draft"])
def test_role_mask_forward(pairs, model):
    """Rows 1 and 3 masked out of a 3-token paged window: the cache
    preamble equals the JAX ``forward_cache_ctx``'s; the pool changes only
    at the unmasked rows' window slots and on the scratch page; the
    unmasked rows' logits are bitwise those of a batch of those rows
    alone."""
    _, (tt, td) = pairs
    m = tt if model == "target" else td
    cfg = m.cfg
    b, s, ps, mp = 4, 3, 8, 3
    n_pages = b * mp  # scratch page: n_pages
    rng = np.random.RandomState(3)
    table = rng.permutation(n_pages).reshape(b, mp).astype(np.int32)
    lengths = np.array([5, 9, 0, 13], np.int32)
    mask = np.array([True, False, True, False])
    tokens = rng.randint(0, cfg.vocab, size=(b, s)).astype(np.int32)

    jcache = {"lengths": jnp.asarray(lengths), "page_table": jnp.asarray(table),
              "role_mask": jnp.asarray(mask),
              "attn": {"k": jnp.zeros((cfg.n_layers, n_pages + 1, ps, cfg.n_kv, cfg.hd))}}
    j_off, j_pos, (j_table, _, _) = jlayers.forward_cache_ctx(jcache, b, s, "gather")
    t_off, t_pos, (t_table, _) = tlayers.forward_cache_ctx(
        dict(jcache, lengths=torch.as_tensor(lengths), page_table=torch.as_tensor(table),
             role_mask=torch.as_tensor(mask),
             attn={"k": torch.zeros((cfg.n_layers, n_pages + 1, ps, cfg.n_kv, cfg.hd))}), b, s)
    assert t_off.tolist() == np.asarray(j_off).tolist()
    assert t_pos.tolist() == np.asarray(j_pos).tolist()
    assert t_table.tolist() == np.asarray(j_table).tolist()

    g = torch.Generator().manual_seed(0)
    shape = (cfg.n_layers, n_pages + 1, ps, cfg.n_kv, cfg.hd)
    store0 = {n: torch.randn(shape, generator=g) for n in ("k", "v")}
    store = {n: a.clone() for n, a in store0.items()}
    logits, _ = m._apply(m.params, torch.as_tensor(tokens), {
        "lengths": torch.as_tensor(lengths), "page_table": torch.as_tensor(table),
        "role_mask": torch.as_tensor(mask), "attn": store})
    # the slots the unmasked rows' window writes, and the scratch page
    written = torch.zeros(shape[1:3], dtype=torch.bool)
    for r in np.flatnonzero(mask):
        for p in range(lengths[r], lengths[r] + s):
            written[table[r, p // ps], p % ps] = True
    written[n_pages] = True
    for n in ("k", "v"):
        assert torch.equal(store[n][:, ~written], store0[n][:, ~written])
    keep = np.flatnonzero(mask)
    alone = {n: a.clone() for n, a in store0.items()}
    want, _ = m._apply(m.params, torch.as_tensor(tokens[keep]), {
        "lengths": torch.as_tensor(lengths[keep]), "page_table": torch.as_tensor(table[keep]),
        "attn": alone})
    assert torch.equal(logits[torch.as_tensor(keep)], want)
    written[n_pages] = False  # the rows' own slots: the same writes as alone
    for n in ("k", "v"):
        assert torch.equal(store[n][:, written], alone[n][:, written])


def test_adaptive_admission_reserves_long_dl(pairs):
    """Under ``adaptive`` (short_dl 2, long_dl 6) a request reserves prompt
    + max_tokens + long_dl positions: at max_model_len 32 a 4-token prompt
    may ask for 22 tokens, not 23, and two requests of 4 + 15 (+ 6 = 25
    positions, 4 pages of 8) do not fit a 7-page pool together (they would
    at draft_len's 3).  Both engines refuse, admit and queue alike, and
    drain to the same tokens."""
    (jt, jd), (tt, td) = pairs
    prompt = staggered_prompts(1, seed=9)[0][:4]
    for engine, cfg_cls, sp_cls, kw in ((JaxEngine, JaxEngineConfig, JaxSamplingParams, {}),
                                        (Engine, EngineConfig, SamplingParams, {"device": "cpu"})):
        eng = engine(jt if engine is JaxEngine else tt, jd if engine is JaxEngine else td,
                     cfg_cls(max_batch=2, page_size=8, adaptive=True, max_model_len=32), **kw)
        eng.add_request(prompt, sp_cls(max_tokens=22))
        with pytest.raises(ValueError):
            eng.add_request(prompt, sp_cls(max_tokens=23))

    def admitted(engine, tgt, dft, cfg_cls, sp_cls, **kw):
        eng = engine(tgt, dft, cfg_cls(max_batch=2, page_size=8, adaptive=True, num_pages=7,
                                       max_model_len=32), **kw)
        rids = [eng.add_request(prompt, sp_cls(max_tokens=15)) for _ in range(2)]
        eng.step()
        seen = (eng.num_active(), eng.queue_depth(), eng.pool_stats()[0].reserved_pages)
        eng.run()
        return seen, [np.asarray(eng.output_tokens(r)).tolist() for r in rids]

    want = admitted(JaxEngine, jt, jd, JaxEngineConfig, JaxSamplingParams)
    got = admitted(Engine, tt, td, EngineConfig, SamplingParams, device="cpu")
    assert got == want
    assert got[0][:2] == (1, 1)
