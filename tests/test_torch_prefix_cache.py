"""The copy-on-write prefix cache in the port (serving/prefix_cache.py and
its engine wiring) against the JAX package.

- radix-tree units: the reference's unit cases (tests/test_prefix_cache.py)
  written once over a pool class and a cache class and run through both
  packages; every observation (matches, page lists, mirrored rows,
  evictions, stats, free pages) must be equal;
- engine: on the dense smoke pair carried across (params_from_numpy), the
  reference's workload (a donor, then a mid-block fork that copies a page
  on write, a full hit and an exact repeat) under par_mode {off, wdos} x
  kv_quant {none, int8}, tree, and mixed KV + tree: the port's tokens with
  the cache on equal its tokens with it off and the JAX Engine's with it
  on, and the prefix stats equal the JAX Engine's; abort and rerun; the
  pages the tree pins are bitwise unchanged while followers run;
- byte budgets: ``pool_bytes`` gives the reference's page counts, and an
  int8 engine holds >= 3x the fp residents at one budget;
- the four prefix metric families are exported with live values."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side of every test here

from test_torch_models import one_thread, to_numpy_tree  # noqa: F401

from repro.launch.serve import build_pair as jax_build_pair
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving.paged_cache import PagedKVPool as JaxPool
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache
from repro_torch.configs.paper_pair import DLM_SMOKE, TLM_SMOKE
from repro_torch.serving import quantized_lm as tqlm
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams, ServingModel
from repro_torch.serving.paged_cache import PagedKVPool as TorchPool
from repro_torch.serving.prefix_cache import PrefixCache as TorchPrefixCache

pytestmark = pytest.mark.usefixtures("one_thread")
PS = 4  # unit-test page size
S_MAX = 128
MAX_TOKENS = 6

# ---------------------------------------------------------------------------
# Radix-tree units: one scenario, two packages
# ---------------------------------------------------------------------------


class Side:
    """One package's pools and cache, with its KV made from numpy."""

    def __init__(self, pool_cls, cache_cls, to_kv, num_pages=32):
        self.pools = {role: pool_cls(2, 2, 8, num_pages=num_pages, page_size=PS)
                      for role in ("target", "draft")}
        self.cache = cache_cls(self.pools, PS)
        self.to_kv = to_kv

    def dense_kv(self, n, seed):
        rng = np.random.RandomState(seed)
        out = {}
        for role, p in self.pools.items():
            k = rng.randn(p.n_layers, n, p.kv_heads, p.head_dim).astype(np.float32)
            out[role] = (k, -k)
        return out

    def donate(self, prompt, upto, seed=0):
        """A donor request: allocate and append per pool, insert its blocks."""
        prompt = np.asarray(prompt, np.int32)
        kv = self.dense_kv(upto, seed)
        seqs = {}
        for role, p in self.pools.items():
            seq = p.allocate_sequence(upto + PS)
            seq.append(*kv[role])
            seqs[role] = seq
        n = self.cache.insert(prompt, "none", {r: s.pages for r, s in seqs.items()},
                              {r: tuple(self.to_kv(a) for a in kv[r]) for r in kv}, upto)
        return seqs, n

    def seen_match(self, m):
        """What a match shows: None, or (tokens, partial, pages per role,
        mirrored prefix rows per role as numpy)."""
        if m is None:
            return None
        return (m.tokens_matched, m.partial, {r: m.shared_pages(r) for r in self.pools},
                {r: [np.asarray(a) for a in m.prefix_kv(r)] for r in self.pools})


def sc_match_full_blocks_and_cap(side, log):
    prompt = np.arange(10, 23, dtype=np.int32)  # 13 tokens, 3 full blocks
    side.donate(prompt, upto=12)
    log.append(side.cache.node_count)
    log.append(side.seen_match(side.cache.match(prompt, "none")))
    log.append(side.seen_match(side.cache.match(prompt[: PS + 1], "none")))
    log.append(side.seen_match(side.cache.match(prompt, "int8")))


def sc_match_partial_midblock(side, log):
    prompt = np.arange(10, 23, dtype=np.int32)
    side.donate(prompt, upto=12)
    fork = prompt.copy()
    fork[6:] = 400 + np.arange(7)
    log.append(side.seen_match(side.cache.match(fork, "none")))


def sc_prefix_kv_donor_rows(side, log):
    prompt = np.arange(30, 43, dtype=np.int32)
    side.donate(prompt, upto=12, seed=3)
    log.append(side.seen_match(side.cache.match(prompt, "none")))


def sc_eviction_refcounts_and_lru(side, log):
    c = side.cache
    p1 = np.arange(0, 9, dtype=np.int32)
    p2 = np.arange(100, 109, dtype=np.int32)
    seqs1, _ = side.donate(p1, upto=8, seed=1)
    seqs2, _ = side.donate(p2, upto=8, seed=2)
    log += [c.node_count, c.evict_one()]
    for s in seqs1.values():
        s.release()
    m1 = c.match(p1, "none")
    c.acquire(m1)
    log.append(c.evict_one())
    c.release(m1)
    log += [c.evict_one(), side.pools["target"].free_pages, c.node_count, c.evictions,
            c.evict_one(), c.evict_one(), c.node_count]
    for s in seqs2.values():
        s.release()
    log += [c.evict_pages(10), c.node_count, c.stats()]


def sc_eviction_never_frees_mapped_page(side, log):
    c = side.cache
    prompt = np.arange(50, 59, dtype=np.int32)
    seqs, _ = side.donate(prompt, upto=8)
    for s in seqs.values():
        s.release()
    m = c.match(prompt, "none")
    follower = {role: p.allocate_sequence(12, shared_pages=m.shared_pages(role), shared_tokens=8)
                for role, p in side.pools.items()}
    log.append(c.evict_one())
    for s in follower.values():
        s.release()
    log += [c.evict_one(), c.stats()]


def sc_insert_idempotent_skips_partial_tail(side, log):
    prompt = np.arange(0, 11, dtype=np.int32)  # upto=10: 2 full blocks
    seqs, n = side.donate(prompt, upto=10)
    kv = side.dense_kv(10, 0)
    n2 = side.cache.insert(prompt, "none", {r: s.pages for r, s in seqs.items()},
                           {r: tuple(side.to_kv(a) for a in kv[r]) for r in kv}, 10)
    log += [n, n2, side.cache.node_count, side.cache.cached_pages()]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_match_full_blocks_and_cap, sc_match_partial_midblock, sc_prefix_kv_donor_rows,
    sc_eviction_refcounts_and_lru, sc_eviction_never_frees_mapped_page,
    sc_insert_idempotent_skips_partial_tail)}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and bool(np.array_equal(a, b))
    return a == b


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_radix_tree_units_match_reference(name):
    logs = []
    for side in (Side(JaxPool, JaxPrefixCache, np.asarray),
                 Side(TorchPool, TorchPrefixCache, torch.from_numpy)):
        log = []
        SCENARIOS[name](side, log)
        logs.append(log)
    assert logs[0] and _equal(logs[0], logs[1]), logs


def test_mirrors_keep_bfloat16():
    """The mirrors are torch tensors, so a bf16 model's rows keep their
    dtype (numpy has no bfloat16)."""
    side = Side(TorchPool, TorchPrefixCache, lambda a: torch.from_numpy(a).to(torch.bfloat16))
    side.donate(np.arange(9, dtype=np.int32), upto=8)
    k, v = side.cache.match(np.arange(9, dtype=np.int32), "none").prefix_kv("draft")
    assert k.dtype == v.dtype == torch.bfloat16 and k.shape == (2, 8, 2, 8)


# ---------------------------------------------------------------------------
# Engine: the acceptance matrix on the dense pair
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pairs():
    """(JAX dense pair, port dense pair on the CPU, weights carried across)."""
    jt, jd = jax_build_pair(seed=0, s_max=S_MAX, quantize=False)
    tt, td = (ServingModel(cfg, tqlm.params_from_numpy(to_numpy_tree(m.params), cfg, "bf16",
                                                       "cpu"),
                           mode="bf16", s_max=S_MAX, device="cpu")
              for m, cfg in ((jt, TLM_SMOKE), (jd, DLM_SMOKE)))
    return (jt, jd), (tt, td)


def _workload():
    """Donor + mid-block divergence (COW) + full hit on a partial page +
    exact repeat (the reference's)."""
    donor = np.arange(7, 48, dtype=np.int32)  # 41 tokens, 5 full blocks at 8
    fork = np.concatenate([donor[:33], np.arange(200, 208, dtype=np.int32)])
    return donor, [fork, donor[:34].copy(), donor.copy()]


TREE = dict(spec_mode="tree", tree_budget=5, spec_branches=2)
MATRIX = {
    "off_none": dict(),
    "off_int8": dict(kv_quant="int8"),
    "wdos_none": dict(par_mode="wdos"),
    "wdos_int8": dict(par_mode="wdos", kv_quant="int8"),
    "tree": TREE,
    "mixed_tree": dict(TREE, kv_quant="mixed"),
}


def _run(engine_cls, cfg_cls, sp_cls, pair, prefix_on, cfg, device=None):
    """The workload through one engine: the donor alone, then the followers
    (under mixed KV the donor once per kind and the followers alternating,
    starting with int8)."""
    kw = {} if device is None else dict(device=device)
    eng = engine_cls(*pair, cfg_cls(max_batch=2, page_size=8, draft_len=3,
                                    prefix_cache=prefix_on, **cfg), **kw)
    donor, followers = _workload()
    if cfg.get("kv_quant") == "mixed":
        first = [donor, donor]
        kinds = ["none", "int8"], ["int8", "none", "int8"]
    else:
        first, kinds = [donor], ([None], [None] * len(followers))
    a, _ = eng.run(first, [sp_cls(max_tokens=MAX_TOKENS, kv_quant=k) for k in kinds[0]])
    b, summary = eng.run(followers, [sp_cls(max_tokens=MAX_TOKENS, kv_quant=k) for k in kinds[1]])
    return [np.asarray(t).tolist() for t in a + b], summary, eng


def _port(pairs, prefix_on, cfg):
    return _run(Engine, EngineConfig, SamplingParams, pairs[1], prefix_on, cfg, device="cpu")


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_sharing_tokens_and_stats_match_jax(pairs, name):
    cfg = MATRIX[name]
    want, jsum, _ = _run(JaxEngine, JaxEngineConfig, JaxSamplingParams, pairs[0], True, cfg)
    off, _, _ = _port(pairs, False, cfg)
    on, summary, eng = _port(pairs, True, cfg)
    assert on == off == want
    st = summary["prefix_cache"]
    assert st == jsum["prefix_cache"]
    assert st["hits"] >= 3 and st["cow_copies"] >= 1 and st["tokens_saved"] > 0
    for pool in eng.pool_stats():  # drained: only the tree's pins are left
        assert pool.used_pages == eng._prefix.node_count


def test_sharing_survives_abort_and_rerun(pairs):
    """Aborting a request that maps shared pages drops its references only:
    later requests still hit the same nodes, with the tokens of the cache
    off and of the JAX Engine."""
    donor, followers = _workload()

    def drive(engine_cls, cfg_cls, sp_cls, pair, prefix_on, **kw):
        eng = engine_cls(*pair, cfg_cls(max_batch=2, page_size=8, draft_len=3,
                                        prefix_cache=prefix_on), **kw)
        sp = sp_cls(max_tokens=MAX_TOKENS)
        eng.run([donor], sp)
        rid = eng.add_request(followers[0], sp)
        eng.step()
        assert eng.abort(rid)
        used = eng.pool_stats()[0].used_pages
        outs = [np.asarray(eng.run([f], sp)[0][0]).tolist() for f in followers]
        return outs, used, eng.summary().get("prefix_cache")

    want, _, jst = drive(JaxEngine, JaxEngineConfig, JaxSamplingParams, pairs[0], True)
    off, _, _ = drive(Engine, EngineConfig, SamplingParams, pairs[1], False, device="cpu")
    on, used, st = drive(Engine, EngineConfig, SamplingParams, pairs[1], True, device="cpu")
    assert used > 0  # the tree's pins survive the abort
    assert on == off == want
    assert st == jst and st["hits"] >= 3


def _rows(eng, pinned):
    """Copies of the pool rows of ``pinned`` ({kind: {role: pages}})."""
    stores = {"target": eng._t_stores, "draft": eng._d_stores}
    return {(kind, role): {name: a[:, pages].clone() for name, a in stores[role][kind].items()}
            for kind, by_role in pinned.items() for role, pages in by_role.items()}


@pytest.mark.parametrize("cfg", [dict(), dict(TREE, kv_quant="mixed")], ids=["chain", "mixed_tree"])
def test_pinned_pages_never_written(pairs, cfg):
    """Followers (a fork that copies on write and donates a block, a full
    hit, a repeat) and their rounds (rewinds, tree compaction) leave every
    page the tree pinned before them as the donor wrote it."""
    donor, followers = _workload()
    eng = Engine(*pairs[1], EngineConfig(max_batch=3, page_size=8, draft_len=3,
                                         prefix_cache=True, **cfg), device="cpu")
    kinds = ["none", "int8"] if cfg.get("kv_quant") == "mixed" else [None]
    eng.run([donor] * len(kinds), [SamplingParams(max_tokens=MAX_TOKENS, kv_quant=k)
                                   for k in kinds])
    pinned = eng._prefix.pinned_pages()
    assert sorted(pinned) == sorted(k or "none" for k in kinds)
    assert all(len(p) == 5 for by_role in pinned.values() for p in by_role.values())
    before = _rows(eng, pinned)
    sps = [SamplingParams(max_tokens=MAX_TOKENS, kv_quant=kinds[i % len(kinds)])
           for i in range(len(followers))]
    eng.run(followers, sps)
    assert eng.summary()["prefix_cache"]["hits"] == len(followers)
    after = _rows(eng, pinned)
    for key in before:
        for name in before[key]:
            assert torch.equal(before[key][name], after[key][name]), (key, name)


# ---------------------------------------------------------------------------
# Byte budgets and metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["none", "int8", "mixed"])
def test_pool_bytes_gives_reference_page_counts(pairs, kv_quant):
    cfg = dict(max_batch=4, page_size=8, kv_quant=kv_quant, pool_bytes=256 * 1024)
    jeng = JaxEngine(*pairs[0], JaxEngineConfig(**cfg))
    teng = Engine(*pairs[1], EngineConfig(**cfg), device="cpu")
    for jp, tp in zip(jeng.pool_stats(), teng.pool_stats()):
        assert tp.num_pages == jp.num_pages > 0


def _resident_at_budget(pairs, kv_quant, pool_bytes):
    eng = Engine(*pairs[1], EngineConfig(max_batch=16, page_size=8, draft_len=3,
                                         kv_quant=kv_quant, pool_bytes=pool_bytes), device="cpu")
    prompt = np.arange(3, 19, dtype=np.int32)  # 16 tokens
    for i in range(16):
        eng.add_request(prompt + i, SamplingParams(max_tokens=24))
    eng.step()
    return eng.num_active()


def test_int8_admits_more_requests_at_same_byte_budget(pairs):
    """Admission counts pool bytes: at one budget an int8 engine holds >= 3x
    the resident requests of an fp engine (int8 values + f32 scales
    against f32 values)."""
    budget = 256 * 1024
    fp = _resident_at_budget(pairs, "none", budget)
    int8 = _resident_at_budget(pairs, "int8", budget)
    assert 0 < fp < 16, f"budget not binding for fp ({fp} resident)"
    assert int8 / fp >= 3.0, (fp, int8)


def test_prefix_metric_families_export(pairs):
    eng = Engine(*pairs[1], EngineConfig(max_batch=2, page_size=8, draft_len=3,
                                         prefix_cache=True), device="cpu")
    donor, followers = _workload()
    sp = SamplingParams(max_tokens=4)
    eng.run([donor], sp)
    eng.run(followers, sp)
    text = eng.metrics.render()
    for name in ("prefix_hit_rate", "prefill_tokens_saved_total",
                 'shared_pages{pool="target",state="cached"}', "prefix_cow_total"):
        assert name in text, name

    def value(name):
        lines = [ln for ln in text.splitlines() if ln.startswith(f"serving_{name} ")]
        return float(lines[0].rsplit(" ", 1)[1])

    st = eng.stats_snapshot()["prefix_cache"]
    assert value("prefix_hit_rate") == st["hit_rate"] > 0
    assert value("prefill_tokens_saved_total") == st["tokens_saved"] > 0
    assert value("prefix_cow_total") == st["cow_copies"] > 0
    assert value('shared_pages{pool="target",state="cached"}') == st["nodes"] > 0
