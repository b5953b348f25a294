"""Sharded training in the port over local gloo worlds of CPU ranks: the
Trainer's steps on meshes (2, 1), (1, 2) and (2, 2) (data parallelism,
tensor parallelism with Megatron sequence sharding, ZeRO-1 moments; FSDP
on (2, 2); the MoE families' expert-parallel all-to-all and dense combine) against the port's one-device Trainer and the JAX Trainer's
step built without a mesh (its step fails on ``make_cpu_mesh()`` under
JAX 0.9), checkpoints across mesh shapes and packages, and the elastic
re-mesh from 4 ranks to 2.

Tolerances (float32 smoke configs): loss atol 1e-5 and grad_norm rtol
1e-5, as tests/test_torch_train.py holds the one-device port (the global
norm adds the ranks' sums of squares in another order; the default clip
of 1.0 is active, the norms are ~13); parameters after six steps atol
5e-5 (Adam moves a parameter whose gradient is near zero by up to 2 lr_t
a step on a last-bit difference; lr_t <= 3e-4 here, observed <= 2.2e-5).
Restored checkpoints and the elastic run's steps before the failure are
bit for bit.  The SSM (mamba2), hybrid (zamba2) and audio (whisper)
families train on (1, 2) too, three steps, against the same references
(their JAX steps built here).  One world per mesh shape runs every
variant that trains on it (``train_world``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp

import torch_mesh_cases as C
from repro import configs as jconfigs
from repro.checkpoint import store as jckpt
from repro.launch.mesh import make_cpu_mesh as jmake_cpu_mesh
from repro.launch.train import Trainer as JTrainer
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import mesh as tmesh
from repro_torch.models import convert, lm as tlm
from repro_torch.optim import optimizer_specs

LOSS_ATOL = 1e-5
NORM_RTOL = 1e-5
PARAM_ATOL = 5e-5
STEPS, SEQ, BATCH, SAVE_AT = 6, 16, 4, 2
FAMILIES = ("mamba2", "zamba2", "whisper")
FAMILY_STEPS = 3  # the families' runs: an update after the first and the checkpoint at SAVE_AT
# the runs that save a checkpoint at SAVE_AT
SAVES = {("deepseek", (2, 2))} | {(name, (1, 2)) for name in FAMILIES}
VARIANTS = [("deepseek", "deepseek-67b", {}, [(2, 1), (1, 2), (2, 2)]),
            ("qwen3-fsdp", "qwen3-8b", {"fsdp": True}, [(2, 2)]),
            # the expert-parallel all-to-all's backward, sequence-sharded; capacity
            # E / k holds every token, so the JAX dense combine is its reference
            ("moonshot-a2a", "moonshot-v1-16b-a3b", {"moe_impl": "a2a", "capacity_factor": 4.0},
             [(1, 2), (2, 2)]),
            # the dense combine's replicated-stream backward (gather_replicated)
            ("grok-dense-nosp", "grok-1-314b", {"seq_shard": False}, [(1, 2)]),
            # the families whose blocks regroup their shards per layer
            ("mamba2", "mamba2-1.3b", {}, [(1, 2)]),
            ("zamba2", "zamba2-7b", {}, [(1, 2)]),
            ("whisper", "whisper-large-v3", {}, [(1, 2)])]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per variant: the JAX step's history and params, the port's one-device
    run, and the port's run on each mesh (the (2, 2) deepseek run and the
    families' (1, 2) runs save a checkpoint at step SAVE_AT).  One world per
    mesh shape, (2, 2) then (1, 2) then (2, 1), also restores:
    the (2, 2) one a checkpoint the JAX Trainer wrote ("jax_22"), the (2, 1)
    one the (2, 2) deepseek run's ("deepseek_21") and the families' (1, 2)
    checkpoints (under their names)."""
    out, worlds = {}, {}
    jax_ckpt = str(tmp_path_factory.mktemp("jax_ckpt"))
    for name, arch, fields, meshes in VARIANTS:
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **fields)
        tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **fields)
        jt = JTrainer(jcfg, jmake_cpu_mesh(), seq_len=SEQ, global_batch=BATCH)
        jt.mesh = None
        if name == "deepseek":  # the checkpoint the (2, 2) world restores
            jt.ckpt = jckpt.AsyncCheckpointer(jax_ckpt)
            jt.ckpt.save(7, {"params": jt.params, "opt": jt.opt_state})
            jt.ckpt.wait()
            out["jax_ckpt"] = _np(jt.params)
        params0 = _np(jt.params)
        jp, jo = params0, _np(jt.opt_state)
        steps = FAMILY_STEPS if name in FAMILIES else STEPS
        jhist = []
        step_fn = jt._build_step()
        for step in range(steps):
            args = (jnp.asarray(step), jnp.asarray(jt.data.batch(step)))
            if jcfg.family.value == "audio":  # the reference Trainer's stand-in frames
                args += (jax.random.normal(jax.random.PRNGKey(step),
                                           (BATCH, jcfg.n_audio_frames, jcfg.d_model),
                                           jcfg.jdtype),)
            jp, jo, m = step_fn(jp, jo, *args)
            jhist.append((float(m["loss"]), float(m["grad_norm"])))
        one = C.train_case(tmesh.make_cpu_mesh(), tcfg, params0, steps, SEQ, BATCH)
        out[name] = {"cfg": tcfg, "jcfg": jcfg, "jhist": jhist, "jparams": _np(jp),
                     "params0": params0, "one": one, "sharded": {}}
        for mesh in meshes:
            ckpt = str(tmp_path_factory.mktemp("ckpt")) if (name, mesh) in SAVES else None
            worlds.setdefault(mesh, []).append(
                (name, ckpt, (tcfg, params0, steps, SEQ, BATCH, ckpt, SAVE_AT)))
    out["restores"] = {}
    for mesh in ((2, 2), (1, 2), (2, 1)):  # a world's checkpoints exist before it starts
        restores = []
        if mesh == (2, 2):
            restores = [("jax_22", (out["deepseek"]["cfg"], jax_ckpt, SEQ, BATCH))]
        if mesh == (2, 1):
            restores = [("deepseek_21", (out["deepseek"]["cfg"],
                                         out["deepseek"]["sharded"][(2, 2)][1], SEQ, BATCH))]
            restores += [(n, (out[n]["cfg"], out[n]["sharded"][(1, 2)][1], SEQ, BATCH))
                         for n in FAMILIES]
        trains = worlds[mesh]
        res = tmesh.spawn(C.train_world, *mesh, device="cpu",
                          args=([t[2] for t in trains], [r[1] for r in restores]))
        for i, (name, ckpt, _) in enumerate(trains):
            out[name]["sharded"][mesh] = ([r["train"][i] for r in res], ckpt)
        for i, (key, _) in enumerate(restores):
            out["restores"][key] = [r["restore"][i] for r in res]
    return out


def _cases():
    return [(name, mesh) for name, _, _, meshes in VARIANTS for mesh in meshes]


@pytest.mark.parametrize("name,mesh", _cases(), ids=lambda v: str(v))
def test_sharded_steps_match_one_device_and_jax(runs, name, mesh):
    r = runs[name]
    results, _ = r["sharded"][mesh]
    for rank in results:
        for (loss, norm), (jl, jn), (ol, on) in zip(rank["hist"], r["jhist"],
                                                    r["one"]["hist"]):
            assert abs(loss - jl) <= LOSS_ATOL and abs(loss - ol) <= LOSS_ATOL
            assert norm == pytest.approx(jn, rel=NORM_RTOL)
            assert norm == pytest.approx(on, rel=NORM_RTOL)
    want = tree_leaves(convert.params_from_numpy(r["jparams"], r["cfg"], "cpu"))
    for got, jgot, one in zip(tree_leaves(results[0]["params"]), want,
                              tree_leaves(r["one"]["params"])):
        np.testing.assert_allclose(got, jgot.numpy(), atol=PARAM_ATOL, rtol=0)
        np.testing.assert_allclose(got, one, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("name,mesh", _cases(), ids=lambda v: str(v))
def test_zero1_moment_slices(runs, name, mesh):
    """ZeRO-1 exactly where the reference's step uses it: each moment cut
    over ``data`` along optimizer_specs' dimension (none under FSDP, where
    the moments follow the parameters' specs), read at one
    tensor-parallel weight of the family (``C.probe_path``)."""
    r = runs[name]
    cfg = r["cfg"]
    results, _ = r["sharded"][mesh]
    full = tlm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    specs = tlm.param_specs(cfg, mesh[1])
    zero1 = None if cfg.fsdp else "data"
    want = optimizer_specs(specs, full, zero1_axis=zero1, axis_size=mesh[0])["mu"]
    path = C.probe_path(cfg)
    spec = C.at_path(want, path)
    assert results[0]["moment_specs"] == spec
    shape = C.at_path(full, path).shape
    sizes = {"data": mesh[0], "model": mesh[1], None: 1}
    assert results[0]["mu_local"]["probe"] == tuple(n // sizes[a] for n, a in
                                                    zip(shape, spec))
    for rank in results:  # the gathered moments are every rank's, and one device's
        for a, b in zip(tree_leaves(rank["mu"]), tree_leaves(results[0]["mu"])):
            np.testing.assert_array_equal(a, b)


def test_checkpoints_across_meshes_and_packages(runs):
    """The (2, 2) run's step-2 checkpoint (gathered whole, written by rank
    0) restores onto (1, 1) and (2, 1) bit for bit, and the JAX package
    reads it, as the SSM, hybrid and audio families' (1, 2) checkpoints
    do; a checkpoint the JAX Trainer writes restores onto (2, 2).
    On (2, 1) and (2, 2) the store's mesh round trip (save gathered to
    rank 0, load cut to the rank's blocks) gives each rank its shard back
    bit for bit."""
    r = runs["deepseek"]
    cfg = r["cfg"]
    _, ckpt = r["sharded"][(2, 2)]
    step, saved, _ = jckpt.load_checkpoint(ckpt)
    assert step == SAVE_AT
    onto_one = C.restore_case(tmesh.make_cpu_mesh(), cfg, ckpt, SEQ, BATCH)
    onto_21 = runs["restores"]["deepseek_21"]
    for n in FAMILIES:  # (1, 2) -> (1, 1) and (2, 1)
        fcfg, fckpt = runs[n]["cfg"], runs[n]["sharded"][(1, 2)][1]
        fstep, fsaved, _ = jckpt.load_checkpoint(fckpt)
        assert fstep == SAVE_AT
        fwant = tree_leaves(convert.from_reference(_np(fsaved["params"]), fcfg))
        for got in [C.restore_case(tmesh.make_cpu_mesh(), fcfg, fckpt, SEQ, BATCH)] + \
                runs["restores"][n]:
            assert got["step"] == SAVE_AT + 1
            assert got.get("round_trip_bitwise", True)
            for a, b in zip(tree_leaves(got["params"]), fwant):
                np.testing.assert_array_equal(a, np.asarray(b))
    want = tree_leaves(convert.from_reference(_np(saved["params"]), cfg))
    for got in [onto_one] + onto_21:
        assert got["step"] == SAVE_AT + 1 and got["count"] == SAVE_AT + 1
        for a, b in zip(tree_leaves(got["params"]), want):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(tree_leaves(got["mu"]),
                        tree_leaves(convert.from_reference(_np(saved["opt"]["mu"]), cfg))):
            np.testing.assert_array_equal(a, np.asarray(b))
    onto_22 = runs["restores"]["jax_22"]  # the JAX Trainer's checkpoint, in the (2, 2) world
    want = tree_leaves(convert.from_reference(runs["jax_ckpt"], cfg))
    for got in onto_21 + onto_22:  # save_checkpoint / load_checkpoint with mesh and specs
        assert got["round_trip_bitwise"]
    for got in onto_22:
        assert got["step"] == 8
        for a, b in zip(tree_leaves(got["params"]), want):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_elastic_remesh_four_ranks_to_two(runs, tmp_path):
    """Two hosts of two ranks train on (2, 2); host 1 is lost at tick 5,
    the world re-forms as (1, 2) and resumes from the step-4 checkpoint.
    The steps before the failure are the uninterrupted (2, 2) run's bit for
    bit; every step is within LOSS_ATOL of the one-device run; the two
    ranks that left return None."""
    r = runs["deepseek"]
    res = tmesh.spawn(C.elastic_case, 2, 2, device="cpu",
                      args=(r["cfg"], str(tmp_path), 5, STEPS + 2, SEQ, BATCH, r["params0"]))
    assert [e is None for e in res] == [False, False, True, True]
    hist = res[0]["hist"]
    assert [h["event"] for h in hist] == ["step"] * 5 + ["restart"] + ["step"] * 3
    assert hist[5] == {"event": "restart", "step": 5, "n_hosts": 1}
    assert [h["n_hosts"] for h in hist if h["event"] == "step"] == [2] * 5 + [1] * 3
    uninterrupted = [h[0] for h in r["sharded"][(2, 2)][0][0]["hist"]]
    before = [h["loss"] for h in hist[:5]]
    assert before == uninterrupted[:5]
    one = C.train_case(tmesh.make_cpu_mesh(), r["cfg"], r["params0"], STEPS + 2, SEQ, BATCH)
    for h in hist:
        if h["event"] == "step":
            assert abs(h["loss"] - one["hist"][h["step"]][0]) <= LOSS_ATOL
    assert res[1]["hist"] == hist
