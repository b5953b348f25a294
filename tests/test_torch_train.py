"""The training path in the port against the JAX package: ``loss_fn`` and
its gradients for every configuration of the registry, remat against no
remat, three ``Trainer`` steps against the reference Trainer's step from
the same weights, AdamW / schedules / int8 gradient compression, the
synthetic data stream, ``prng.normal``, the fault-tolerance runtime, and
the launch helpers (mesh, parameter counts, the CLI).

The reference Trainer is driven through its own ``_build_step`` with its
mesh set to None: under JAX 0.9 its step fails on a ``make_cpu_mesh()``
mesh (a ShardingTypeError in the embedding gather), and without a mesh
it computes the same single-device function.

Tolerances (float32 smoke configs on both sides):
- loss: atol 1e-5 (observed <= 1e-6: summation order of the logsumexp
  and mean);
- gradients: each leaf within 1e-4 of its own max |g| (observed <= 3.4e-5
  on the SSM leaves, whose float32 SSD sums in another order; <= 2e-6
  elsewhere);
- grad_norm: rtol 1e-5;
- parameters after three steps: atol 1e-5.  Adam divides by sqrt(nu), so
  where a gradient is near zero a last-bit difference can move a
  parameter by up to 2 * lr_t per step (lr_t <= 1e-4 in these steps);
  observed <= 6e-8.
Remat must give the no-remat loss and gradients bit for bit; data
batches must be bitwise equal."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
from test_torch_models import one_thread  # noqa: F401

from repro import configs as jconfigs
from repro import data as jdata
from repro import optim as joptim
from repro import runtime as jruntime
from repro.launch import steps as jsteps
from repro.launch.mesh import make_cpu_mesh as jmake_cpu_mesh
from repro.launch.train import Trainer as JTrainer
from repro.models import lm as jlm
from repro.models import whisper as jW
from repro.models.common import Family
from repro_torch import configs as tconfigs
from repro_torch import data as tdata
from repro_torch import optim as toptim
from repro_torch import runtime as truntime
from repro_torch.core import prng
from repro_torch.core.tree import TORCH_DTYPES, tree_leaves, tree_map, tree_unflatten
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.serving import quantized_lm as tqlm

pytestmark = pytest.mark.usefixtures("one_thread")
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
NORM_RTOL = 1e-5
PARAM_ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jinit(jcfg, seed):
    init = jW.init_whisper if jcfg.family is Family.AUDIO else jlm.init_lm
    return jax.jit(lambda k: init(k, jcfg, tp=1)[0])(jax.random.PRNGKey(seed))


def _extras(jcfg, rng, batch):
    """(JAX kwargs, port kwargs): a VLM's vision embeddings, whisper's frames."""
    if jcfg.family is Family.VLM:
        v = rng.randn(batch, jcfg.n_vision_tokens, jcfg.d_model).astype(np.float32)
        return {"vision_embeds": jnp.asarray(v)}, {"vision_embeds": torch.from_numpy(v)}
    if jcfg.family is Family.AUDIO:
        f = rng.randn(batch, jcfg.n_audio_frames, jcfg.d_model).astype(np.float32)
        return {"frames": jnp.asarray(f)}, {"frames": torch.from_numpy(f)}
    return {}, {}


def _grads(params, cfg, toks, kw):
    params = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = tlm.loss_fn(params, cfg, toks, **kw)
    return loss.detach(), tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_and_grads_match(arch):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    (the reference's smoke train step), and remat bit for bit against no
    remat."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    params = _jinit(jcfg, 0)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab, (2, 17)).astype(np.int32)
    jkw, tkw = _extras(jcfg, rng, 2)
    if jcfg.family is Family.AUDIO:
        fn = lambda p: jW.whisper_loss_fn(p, jcfg, None, jnp.asarray(toks), jkw["frames"])  # noqa
    else:
        fn = lambda p: jlm.loss_fn(p, jcfg, None, jnp.asarray(toks), **jkw)  # noqa: E731
    jloss, jgrads = jax.jit(jax.value_and_grad(fn))(params)
    tparams = tqlm.params_from_numpy(_np(params), tcfg, "bf16", "cpu")
    assert tcfg.remat
    loss, grads = _grads(tparams, tcfg, torch.from_numpy(toks), tkw)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    want = jax.tree.leaves(_np(jgrads))
    got = tree_leaves(convert.to_reference(grads, tcfg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_RTOL * max(np.abs(w).max(), 1e-30))
    loss2, grads2 = _grads(tparams, dataclasses.replace(tcfg, remat=False),
                           torch.from_numpy(toks), tkw)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(grads2)))


@pytest.fixture(scope="module")
def reference_trainers():
    """{arch: the reference Trainer (seq 16, batch 4) with its initial
    params and state as numpy trees}, built on first use; each test steps
    its own device copies."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jt = JTrainer(jconfigs.get_smoke(arch), jmake_cpu_mesh(), seq_len=16, global_batch=4)
            jt.mesh = None
            # host copies: the jitted step donates (deletes) the arrays it is given
            jt.params, jt.opt_state = _np(jt.params), _np(jt.opt_state)
            jt._jit_step = jt._build_step()
            cache[arch] = jt
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "whisper-large-v3"])
def test_trainer_three_steps_match(reference_trainers, arch):
    """Three steps of the port's Trainer against the reference Trainer's
    jitted step (batches of its SyntheticLMDataset, its schedule; for
    whisper its jax.random.normal frames against the port's prng.normal):
    loss and grad_norm per step, parameters and moments after."""
    jt = reference_trainers(arch)
    jcfg, tcfg = jt.cfg, tconfigs.get_smoke(arch)
    tt = ttrain.Trainer(tcfg, tmesh.make_cpu_mesh(), seq_len=16, global_batch=4,
                        params=tqlm.params_from_numpy(_np(jt.params), tcfg, "bf16", "cpu"))
    assert tt.device == torch.device("cpu")
    jparams, jopt = jt.params, jt.opt_state
    for step in range(3):
        batch = jnp.asarray(jt.data.batch(step))
        np.testing.assert_array_equal(tt.data.batch(step), np.asarray(batch))
        args = (jparams, jopt, jnp.asarray(step), batch)
        if jcfg.family is Family.AUDIO:
            frames = jax.random.normal(jax.random.PRNGKey(step),
                                       (4, jcfg.n_audio_frames, jcfg.d_model), jcfg.jdtype)
            np.testing.assert_allclose(tt.frames(step).numpy(), np.asarray(frames), atol=1e-6)
            args += (frames,)
        jparams, jopt, m = jt._jit_step(*args)
        got = tt.train_step()
        tt.step += 1
        assert abs(float(got["loss"]) - float(m["loss"])) <= LOSS_ATOL, step
        assert float(got["grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=NORM_RTOL)
    tree = tt.checkpoint_tree()
    for got, want in ((tree["params"], jparams), (tree["opt"]["mu"], jopt["mu"]),
                      (tree["opt"]["nu"], jopt["nu"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(_np(want))):
            np.testing.assert_allclose(g.numpy(), w, atol=PARAM_ATOL)
    assert int(tree["opt"]["count"]) == int(jopt["count"]) == 3


def test_trainer_run_history_and_restore(tmp_path):
    """The reference's run loop: history entries, the checkpoint cadence,
    and restore() continuing after the latest checkpoint with the same
    losses as an uninterrupted run."""
    cfg = tconfigs.get_smoke("mamba2-1.3b")
    tr = ttrain.Trainer(cfg, tmesh.make_cpu_mesh(), seq_len=8, global_batch=2,
                        ckpt_dir=str(tmp_path))
    hist = tr.run(steps=5, ckpt_every=2, log_every=100)
    assert [h["step"] for h in hist] == list(range(5)) and set(hist[0]) == {"step", "loss"}
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000000", "step_00000002", "step_00000004"]
    again = ttrain.Trainer(cfg, tmesh.make_cpu_mesh(), seq_len=8, global_batch=2,
                           ckpt_dir=str(tmp_path))
    assert again.restore() and again.step == 5
    cont = tr.run(steps=2, ckpt_every=100, log_every=100)
    assert again.run(steps=2, ckpt_every=100, log_every=100) == cont
    assert not ttrain.Trainer(cfg, tmesh.make_cpu_mesh(), seq_len=8, global_batch=2).restore()


def test_trainer_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.Trainer(tconfigs.get_smoke("mamba2-1.3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "mamba2-1.3b", "--smoke", "--steps", "1"])


def test_cli_trains_on_the_cpu(capsys):
    assert ttrain.main(["--arch", "zamba2-7b", "--smoke", "--steps", "2", "--seq-len", "8",
                        "--batch", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=zamba2-smoke" in out and "device=cpu" in out and "loss " in out


def test_mesh_is_one_device(monkeypatch):
    """Without a process group the mesh is one device; a larger mesh needs a
    world of its size (tests/test_torch_mesh.py runs them), and the
    production mesh a torchrun world of 256 or 512 ranks."""
    m = tmesh.make_cpu_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.device == torch.device("cpu")
    for kw in ({"data": 2}, {"model": 16}):
        with pytest.raises(RuntimeError, match="needs a process group"):
            tmesh.make_cpu_mesh(**kw)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for mp in (False, True):
        with pytest.raises(RuntimeError, match="torchrun"):
            tmesh.make_production_mesh(multi_pod=mp)
    with pytest.raises(RuntimeError, match="torchrun"):
        ttrain.main(["--arch", "mamba2-1.3b", "--multi-pod"])


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_counts_match(arch):
    for get in ("get_config", "get_smoke"):
        assert tsteps.param_counts(getattr(tconfigs, get)(arch)) == \
            jsteps.param_counts(getattr(jconfigs, get)(arch))
    cfg = tconfigs.get_smoke(arch)
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    assert tlm.param_count(params) == jlm.param_count(_jinit(jconfigs.get_smoke(arch), 0))


# ---------------------------------------------------------------------------
# optimizer, schedules, compression
# ---------------------------------------------------------------------------


def _tree(rng, dtype=np.float32):
    return {"a": rng.randn(5, 3).astype(dtype), "b": [rng.randn(7).astype(dtype)],
            "c": {"d": rng.randn(2, 2).astype(dtype)}}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment_dtype):
    """Five updates of one tree through both packages, the port started
    from the reference's parameters and state after two, clipping active:
    grad_norm rtol 1e-6, params atol 1e-6 (an update of lr 1e-2 amplifies
    a last-bit difference of the moments at most to that), moments in
    their dtype."""
    rng = np.random.RandomState(0)
    cfg_j = joptim.AdamWConfig(lr=1e-2, grad_clip=0.5, moment_dtype=moment_dtype)
    cfg_t = toptim.AdamWConfig(lr=1e-2, grad_clip=0.5, moment_dtype=moment_dtype)
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    jgrads = [jax.tree.map(jnp.asarray, _tree(rng)) for _ in range(5)]
    js = joptim.adamw_init(jp, cfg_j)
    for g in jgrads[:2]:
        jp, js, _ = joptim.adamw_update(jp, g, js, cfg_j, 0.5)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), _np(jp))
    ts = {"mu": tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
              TORCH_DTYPES[moment_dtype]), _np(js["mu"])),
          "nu": tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
              TORCH_DTYPES[moment_dtype]), _np(js["nu"])),
          "count": torch.tensor(int(js["count"]), dtype=torch.int32)}
    for g in jgrads[2:]:
        jp, js, jm = joptim.adamw_update(jp, g, js, cfg_j, 0.5)
        tp, ts, tm = toptim.adamw_update(tp, tree_map(lambda a: torch.from_numpy(np.array(a)),
                                                      _np(g)), ts, cfg_t, 0.5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(_np(jp))):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
        for key in ("mu", "nu"):
            for a, b in zip(tree_leaves(ts[key]), jax.tree.leaves(js[key])):
                assert a.dtype == TORCH_DTYPES[moment_dtype]
                np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                           rtol=1e-2 if moment_dtype == "bfloat16" else 1e-5,
                                           atol=1e-7)
    assert int(ts["count"]) == int(js["count"]) == 5


def test_optim_state_from_numpy_carries_a_trainer_state(reference_trainers):
    jt = reference_trainers("mamba2-1.3b")
    cfg = tconfigs.get_smoke("mamba2-1.3b")
    state = convert.optim_state_from_numpy(_np(jt.opt_state), cfg, "cpu")
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 0
    back = convert.to_reference(state["mu"], cfg)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jt.opt_state["mu"]))
    params = tqlm.params_from_numpy(_np(jt.params), cfg, "bf16", "cpu")
    assert [t.shape for t in tree_leaves(state["nu"])] == [t.shape for t in tree_leaves(params)]


def test_adamw_reduces_quadratic():
    params = {"w": torch.from_numpy(np.random.RandomState(0).randn(32).astype(np.float32))}
    cfg = toptim.AdamWConfig(lr=0.1, weight_decay=0.0)
    state = toptim.adamw_init(params, cfg)
    l0 = float(torch.sum(params["w"] ** 2))
    for _ in range(50):
        params, state, m = toptim.adamw_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(torch.sum(params["w"] ** 2)) < l0 * 1e-2
    assert math.isfinite(float(m["grad_norm"]))


def test_grad_clipping():
    params = {"w": torch.ones(4)}
    cfg = toptim.AdamWConfig(lr=0.0, grad_clip=1.0)
    new, _, m = toptim.adamw_update(params, {"w": torch.full((4,), 1e6)},
                                    toptim.adamw_init(params, cfg), cfg)
    assert float(m["grad_norm"]) > 1e6  # reported before the clip
    assert torch.equal(new["w"], params["w"])


@pytest.mark.parametrize("step", [0, 1, 5, 10, 19, 20, 21, 99, 100, 1999, 2000, 2500])
def test_schedules_match(step):
    got = toptim.linear_warmup_cosine(step, 20, 2000)
    want = joptim.linear_warmup_cosine(jnp.asarray(step), 20, 2000)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    assert float(toptim.cosine_schedule(torch.tensor(step), 100)) == pytest.approx(
        float(joptim.cosine_schedule(jnp.asarray(step), 100)), rel=1e-6)
    assert float(toptim.linear_warmup_cosine(0, 10, 100)) == 0.0
    assert float(toptim.linear_warmup_cosine(100, 10, 100)) == pytest.approx(0.1)


def test_int8_compression_matches_reference():
    """Twenty rounds of compression with error feedback through both
    packages: int8 codes equal, scales and residuals within float32
    rounding, and the accumulated error bounded by one step."""
    rng = np.random.RandomState(0)
    g0 = {"a": rng.randn(64).astype(np.float32), "b": [rng.randn(3, 5).astype(np.float32)]}
    jef, tef = joptim.ef_init(jax.tree.map(jnp.asarray, g0)), toptim.ef_init(
        tree_map(torch.from_numpy, g0))
    total_true, total_deq = np.zeros(64, np.float32), np.zeros(64, np.float32)
    flips = 0
    for _ in range(20):
        g = {"a": rng.randn(64).astype(np.float32), "b": [rng.randn(3, 5).astype(np.float32)]}
        jq, js, jef = joptim.compress_grads_int8(jax.tree.map(jnp.asarray, g), jef)
        tq, ts, tef = toptim.compress_grads_int8(tree_map(torch.from_numpy, g), tef)
        for a, b in zip(tree_leaves(tq), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            diff = np.abs(a.numpy().astype(int) - np.asarray(b).astype(int))
            assert diff.max() <= 1  # a .5-boundary rounding flip at most
            flips += int(diff.sum())
            a.copy_(torch.from_numpy(np.asarray(b)))  # follow the reference after a flip
        for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
            assert float(a) == pytest.approx(float(b), rel=1e-6)
        for a, b in zip(tree_leaves(tef.residual), jax.tree.leaves(jef.residual)):
            a.copy_(torch.from_numpy(np.asarray(b)))
        d = toptim.decompress_grads_int8(tq, ts)
        total_true += g["a"]
        total_deq += d["a"].numpy()
    assert flips <= 2
    assert np.abs(total_true - total_deq).max() < 0.2


# ---------------------------------------------------------------------------
# data, prng.normal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(vocab=101, seq_len=16, global_batch=8, seed=3),
                                dict(vocab=256, seq_len=64, global_batch=8),
                                dict(vocab=32000, seq_len=33, global_batch=4, seed=7,
                                     zipf_a=1.1, bigram_strength=0.5)])
def test_data_batches_bitwise(kw):
    jds, tds = jdata.SyntheticLMDataset(jdata.DataConfig(**kw)), tdata.SyntheticLMDataset(
        tdata.DataConfig(**kw))
    for step in (0, 1, 7, 123):
        got, want = tds.batch(step), jds.batch(step)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        for h in range(4):
            assert np.array_equal(tds.host_slice(step, h, 4), jds.host_slice(step, h, 4))
    it_t = tdata.make_batch_iterator(tdata.DataConfig(**kw), start_step=5, host_id=1, n_hosts=2)
    it_j = jdata.make_batch_iterator(jdata.DataConfig(**kw), start_step=5, host_id=1, n_hosts=2)
    for _ in range(2):
        (st, bt), (sj, bj) = next(it_t), next(it_j)
        assert st == sj and np.array_equal(bt, bj)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
@pytest.mark.parametrize("shape", [(), (5,), (4, 16, 64)])
def test_normal_matches_jax(seed, shape):
    """Within 4 ulp of max(|x|, 1): numpy's log1p differs from XLA's in the
    last bit on some inputs (see core/prng.py); most values are equal."""
    got = prng.normal(prng.PRNGKey(seed), shape)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = np.maximum(np.abs(want), np.float32(1.0)).astype(np.float32)
    assert (np.abs(got.astype(np.float64) - want) / np.spacing(scale)).max() <= 4
    if want.size > 1000:
        assert (got == want).mean() > 0.95


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------


def test_heartbeat_and_straggler_match():
    t = [0.0]
    mons = [pkg.HeartbeatMonitor([0, 1, 2], timeout_s=10.0, clock=lambda: t[0])
            for pkg in (jruntime, truntime)]
    t[0] = 5.0
    for m in mons:
        m.beat(0)
        m.beat(1)
    t[0] = 12.0
    assert [m.dead_hosts() for m in mons] == [[2], [2]]
    for m in mons:
        m.remove(2)
    assert [m.dead_hosts() for m in mons] == [[], []]
    sms = [pkg.StragglerMitigator([0, 1, 2, 3], factor=2.0, window=8)
           for pkg in (jruntime, truntime)]
    rng = np.random.RandomState(0)
    for _ in range(8):
        times = list(rng.rand(3) + 1.0) + [5.0]
        for sm in sms:
            for h, dt in enumerate(times):
                sm.record(h, dt)
    assert sms[0].stragglers() == sms[1].stragglers() == [3]
    for sm in sms:
        sm.remove(3)
    assert sms[0].stragglers() == sms[1].stragglers() == []


def test_elastic_restart_history_matches(tmp_path):
    """The reference's elastic case through both packages: a host dies at
    tick 12, the fleet shrinks and resumes from the last checkpoint; the
    histories (events, steps, fleet sizes, the state's values) are equal."""
    hists = []
    for name, pkg in (("jax", jruntime), ("torch", truntime)):
        failures = iter([None] * 12 + [1] + [None] * 100)
        is_torch = pkg is truntime

        def build(n_hosts, restore, is_torch=is_torch):
            if restore is None:
                w = torch.zeros(4) if is_torch else jnp.zeros((4,), jnp.float32)
            else:
                w = restore[1]["w"] if is_torch else jnp.asarray(restore[1]["w"])

            def step_fn(state, step):
                return {"w": state["w"] + 1.0 / n_hosts}, {"w0": float(state["w"][0])}

            return {"w": w}, step_fn

        kw = {"device": "cpu"} if is_torch else {}
        tr = pkg.ElasticTrainer(pkg.FaultToleranceConfig(ckpt_dir=str(tmp_path / name),
                                                         ckpt_every=5),
                                n_hosts=4, build_fn=build, state_to_tree=lambda s: s,
                                failure_source=lambda: next(failures), min_hosts=2, **kw)
        hists.append((tr.run(30), tr.n_hosts, tr.restarts))
    assert hists[0] == hists[1]
    hist = hists[1][0]
    events = [h["event"] for h in hist]
    assert "restart" in events and hist[events.index("restart")]["step"] > 0
    assert [h["step"] for h in hist if h["event"] == "step"][-1] == 29
    assert hists[1][1] == 3


def test_fault_tolerance_config_needs_a_ckpt_dir(tmp_path):
    """The port's config has no shared default checkpoint directory (two
    runs on one machine would read each other's checkpoints)."""
    with pytest.raises(TypeError):
        truntime.FaultToleranceConfig()
    assert truntime.FaultToleranceConfig(ckpt_dir=str(tmp_path)).ckpt_every == 50
