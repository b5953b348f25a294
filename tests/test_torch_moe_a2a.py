"""The expert-parallel MoE layer of the port (``layers.moe_apply_a2a`` and
the W4A8 ``quantized_lm._moe_a2a_quant``) over local gloo worlds of CPU
ranks, against the JAX package.

* Where a rank holds one expert (or the model axis is 1) the reference's
  all-to-all is right, and the port is held to it on a forced 4-device
  JAX mesh (a subprocess): grok-smoke's 4 experts at (1, 4) with and
  without sequence sharding and at (2, 1), the default capacity factor
  (1.25) dropping slots, which the test checks happen; the ff-split case
  (2 experts at tp 4: each expert's FFN columns over 2 ranks, partial sums
  added on the way back); the W4A8 expert path at (1, 4) and (2, 1).
* Where a rank holds several experts the reference pairs an expert's
  weights with another expert's slots (it reshapes the received (peer,
  expert, slot) blocks to (expert, peer * slot) with no transpose).  The
  port transposes, and with a capacity that drops nothing
  (capacity_factor = E / k) it equals the JAX dense combine at (1, 2),
  (2, 2) and (1, 4) (moonshot-smoke: 8 experts, 4 or 2 a rank).  A test
  asserts the reference's measured miss from its own dense combine at
  (1, 2), so it fails the day the reference changes.

Tolerance: float32 outputs within 1e-5 (observed <= 2e-6: the expert
GEMMs run on other slot counts); the W4A8 path within 1e-5 too (its int32
products are exact)."""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp

import torch_mesh_cases as C
from repro import configs as jconfigs
from repro.models import layers as jL
from repro.serving import quantized_lm as jq
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

ATOL = 1e-5
REFERENCE_MISS = 0.1  # the reference's e_loc > 1 a2a against its dense combine: at least


def _moe(cfg, seed):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": rng.standard_normal((d, e)).astype(np.float32) / float(np.sqrt(d)),
            "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) / float(np.sqrt(d)),
            "w_up": rng.standard_normal((e, d, f)).astype(np.float32) / float(np.sqrt(d)),
            "w_down": rng.standard_normal((e, f, d)).astype(np.float32) / float(np.sqrt(f))}


def _x(cfg, seed, b=4, s=8):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _split_np(moe, e, split):
    """The reference's (E * split) storage of (E, d, f) experts."""
    out = dict(moe)
    for k in ("w_gate", "w_up", "w_down"):
        out[k] = tlm.split_experts(torch.from_numpy(moe[k]), k, e, split).numpy()
    return out


# (name, arch, fields, mesh, seq_sharded, quantized)
AGAINST_JAX_A2A = [
    ("grok-sp-1x4", "grok-1-314b", {}, (1, 4), True, False),
    ("grok-1x4", "grok-1-314b", {}, (1, 4), False, False),
    ("grok-2x1", "grok-1-314b", {}, (2, 1), False, False),
    ("split-1x4", "grok-1-314b", {"n_experts": 2}, (1, 4), False, False),
    ("split-sp-1x4", "grok-1-314b", {"n_experts": 2}, (1, 4), True, False),
    ("w4a8-1x4", "grok-1-314b", {}, (1, 4), False, True),
    ("w4a8-2x1", "grok-1-314b", {}, (2, 1), False, True),
]
DROPLESS = [(1, 2), (2, 2), (1, 4)]

_JAX_A2A = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from repro import configs
    from repro.launch.mesh import activate_mesh
    from repro.models import layers as L
    from repro.serving import quantized_lm as q
    root = sys.argv[1]
    spec = json.load(open(os.path.join(root, "cases.json")))
    z = np.load(os.path.join(root, "inputs.npz"))
    out = {}
    for c in spec:
        cfg = dataclasses.replace(configs.get_smoke(c["arch"]), **c["fields"])
        d, m = c["mesh"]
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                                 ("data", "model"))
        get = lambda k: jnp.asarray(z[c["name"] + "/" + k])
        x = get("x")
        with activate_mesh(mesh):
            if c["quant"]:
                layer = {"router": get("router")}
                for k in ("w_gate", "w_up", "w_down"):
                    layer[k] = {"packed": get(k + "/packed"), "sw": get(k + "/sw")}
                y = q._moe_a2a_quant(layer, x, cfg, mesh, seq_sharded=c["sp"])
            else:
                p = {k: get(k) for k in ("router", "w_gate", "w_up", "w_down")}
                y = L.moe_apply_a2a(p, x, cfg, mesh, seq_sharded=c["sp"])
        out[c["name"]] = np.asarray(y)
    np.savez(os.path.join(root, "outputs.npz"), **out)
""")


@pytest.fixture(scope="module")
def jax_a2a():
    """Inputs of every case and the reference's a2a outputs (subprocess)."""
    cases, arrays = [], {}
    for i, (name, arch, fields, mesh, sp, quant) in enumerate(AGAINST_JAX_A2A):
        tcfg = C.with_fields(tconfigs.get_smoke(arch), **fields)
        jcfg = C.with_fields(jconfigs.get_smoke(arch), **fields)
        moe, x = _moe(tcfg, i), _x(tcfg, 100 + i)
        arrays[f"{name}/x"] = x
        if quant:
            packed = {k: jax.tree.map(np.asarray, jq._quant_pack_experts(jnp.asarray(moe[k])))
                      for k in ("w_gate", "w_up", "w_down")}
            for k, v in packed.items():
                arrays[f"{name}/{k}/packed"], arrays[f"{name}/{k}/sw"] = v["packed"], v["sw"]
            arrays[f"{name}/router"] = moe["router"]
            port = dict(packed, router=moe["router"])
        else:
            split = jL.moe_ff_split(jcfg, mesh[1])
            for k, v in _split_np(moe, tcfg.n_experts, split).items():
                arrays[f"{name}/{k}"] = v
            port = moe
        cases.append({"name": name, "arch": arch, "fields": fields, "mesh": mesh, "sp": sp,
                      "quant": quant})
        cases[-1]["port"] = (tcfg, port, x, sp, quant)
    with tempfile.TemporaryDirectory() as root:
        json.dump([{k: v for k, v in c.items() if k != "port"} for c in cases],
                  open(os.path.join(root, "cases.json"), "w"))
        np.savez(os.path.join(root, "inputs.npz"), **arrays)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
        run = subprocess.run([sys.executable, "-c", _JAX_A2A, root], capture_output=True,
                             text=True, env=env, timeout=900)
        assert run.returncode == 0, run.stderr[-3000:]
        with np.load(os.path.join(root, "outputs.npz")) as z:
            want = {k: z[k] for k in z.files}
    return cases, want


@pytest.fixture(scope="module")
def port_a2a(jax_a2a):
    cases, _ = jax_a2a
    out = {}
    for mesh in sorted({tuple(c["mesh"]) for c in cases}):
        mine = [c for c in cases if tuple(c["mesh"]) == mesh]
        res = tmesh.spawn(C.moe_layer_case, *mesh, device="cpu",
                          args=([c["port"] for c in mine],))
        for i, c in enumerate(mine):
            out[c["name"]] = C.assemble([r[i] for r in res], c["port"][2].shape)
    return out


@pytest.mark.parametrize("name", [c[0] for c in AGAINST_JAX_A2A])
def test_a2a_matches_jax_a2a_where_a_rank_holds_one_expert(jax_a2a, port_a2a, name):
    _, want = jax_a2a
    np.testing.assert_allclose(port_a2a[name], want[name], atol=ATOL, rtol=0)


def test_capacity_drops_happen(jax_a2a):
    """The sequence-sharded grok case drops slots on some rank (so the
    held outputs include the residual path)."""
    cases, _ = jax_a2a
    cfg, moe, x, _, _ = next(c for c in cases if c["name"] == "grok-sp-1x4")["port"]
    dropped = 0
    for r in range(4):
        t = torch.from_numpy(x[:, 2 * r:2 * r + 2].reshape(-1, cfg.d_model))
        cap = tL.moe_capacity(cfg, t.shape[0])
        _, _, keep, _, _ = tL.topk_dispatch(t, torch.from_numpy(moe["router"]), cfg, cap)
        dropped += int((~keep).sum())
    assert dropped > 0


@pytest.fixture(scope="module")
def dropless():
    arch = "moonshot-v1-16b-a3b"
    fields = {"capacity_factor": 4.0}  # E / k: every expert's slots hold every token
    tcfg = C.with_fields(tconfigs.get_smoke(arch), **fields)
    jcfg = C.with_fields(jconfigs.get_smoke(arch), **fields)
    moe, x = _moe(tcfg, 50), _x(tcfg, 51)
    dense = np.asarray(jL.moe_apply_dense({k: jnp.asarray(v) for k, v in moe.items()},
                                          jnp.asarray(x), jcfg))
    return tcfg, moe, x, dense


@pytest.mark.parametrize("mesh", DROPLESS, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("sp", [False, True], ids=["nosp", "sp"])
def test_a2a_matches_dense_where_a_rank_holds_several_experts(dropless, mesh, sp):
    cfg, moe, x, dense = dropless
    assert cfg.n_experts // mesh[1] > 1
    res = tmesh.spawn(C.moe_layer_case, *mesh, device="cpu", args=([(cfg, moe, x, sp, False)],))
    np.testing.assert_allclose(C.assemble([r[0] for r in res], x.shape), dense, atol=ATOL,
                               rtol=0)
    # autograd through the a2a is refused where the model ranks share their tokens
    assert [r[0]["refused"] for r in res] == [None if sp else mesh[1] > 1] * len(res)


_JAX_FAULT = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np, jax, jax.numpy as jnp
    from repro import configs
    from repro.launch.mesh import activate_mesh
    from repro.models import layers as L
    cfg = dataclasses.replace(configs.get_smoke("moonshot-v1-16b-a3b"), capacity_factor=4.0)
    z = np.load(sys.argv[1])
    p = {k: jnp.asarray(z[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(z["x"])
    dense = np.asarray(L.moe_apply_dense(p, x, cfg))
    for d, m in ((1, 1), (1, 2), (2, 2)):
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                                 ("data", "model"))
        with activate_mesh(mesh):
            y = np.asarray(L.moe_apply_a2a(p, x, cfg, mesh, seq_sharded=False))
        print("miss", d, m, float(np.abs(y - dense).max()))
""")


def test_reference_a2a_misses_its_dense_combine_with_several_experts_a_rank(dropless):
    """The reference's fault, measured: with nothing dropped its a2a equals
    its dense combine at (1, 1), where a rank holds all 8 experts but the
    exchange is the identity, and misses it at (1, 2) and (2, 2), where a
    rank holds 4."""
    _, moe, x, _ = dropless
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "moe.npz")
        np.savez(path, x=x, **moe)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
        run = subprocess.run([sys.executable, "-c", _JAX_FAULT, path], capture_output=True,
                             text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    miss = {(int(d), int(m)): float(v) for _, d, m, v in
            (ln.split() for ln in run.stdout.splitlines() if ln.startswith("miss"))}
    print(f"reference a2a against its dense combine: {miss}")
    assert miss[(1, 1)] <= ATOL
    assert miss[(1, 2)] > REFERENCE_MISS and miss[(2, 2)] > REFERENCE_MISS
