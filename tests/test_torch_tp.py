"""The sharded bf16/f32 forward of the port (``lm.apply_lm(..., mesh=)``)
against the JAX package's ``apply_lm`` without a mesh, on the same numpy
weights, over local gloo worlds of CPU ranks at meshes (1, 2), (2, 2),
(1, 4) and (2, 1): tensor parallelism with virtual KV heads (n_kv 2 at tp
4), a head count the model axis does not divide (attention replicated),
Megatron sequence sharding on and off and once per block, FSDP, the VLM's
image tokens and the MoE family's dense combine over gathered experts.
One world per mesh runs every case.

Tolerances (float32 smoke configs): logits within 1e-5 of the JAX
function's (observed <= 4e-6: the sharded sums and the attention's head
groups run in other orders); the greedy tokens of a prefill and three
decode steps over the dense cache equal, their step logits within 1e-5.

A subprocess runs the JAX functions themselves on a forced 4-device CPU
mesh (automatic axes; the explicit axes of ``make_cpu_mesh`` fail under
JAX 0.9) and shows they equal their ``mesh=None`` output."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp

import torch_mesh_cases as C
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh

ATOL = 1e-5
MESHES = [(1, 2), (2, 2), (1, 4), (2, 1)]
STEPS = 3


def _variants():
    """(name, arch, fields): the configurations every mesh runs."""
    return [
        ("deepseek", "deepseek-67b", {}),  # n_kv 2: virtual heads at tp 4
        ("deepseek-nosp", "deepseek-67b", {"seq_shard": False}),
        ("deepseek-once", "deepseek-67b", {"sp_once_per_block": True}),
        ("qwen3-fsdp", "qwen3-8b", {"fsdp": True}),  # qk-norm
        ("nemotron", "nemotron-4-15b", {}),  # squared ReLU
        ("llama3", "llama3-405b", {}),
        ("six-heads", "deepseek-67b", {"n_heads": 6, "head_dim": 16}),  # 6 % 4 != 0
        ("internvl", "internvl2-1b", {}),  # image tokens
        ("grok-dense", "grok-1-314b", {}),  # MoE, dense combine
    ]


def _jax_greedy(jcfg, params, tokens, steps, vision):
    kw = {"vision_embeds": jnp.asarray(vision)} if vision is not None else {}
    s0 = tokens.shape[1] + (vision.shape[1] if vision is not None else 0)
    cache = jlm.init_cache(jcfg, tokens.shape[0], s0 + steps, tp=1)
    fwd = jax.jit(lambda p, t, c, **k: jlm.apply_lm(p, jcfg, None, t, cache=c, **k))
    logits, cache = fwd(params, jnp.asarray(tokens), cache, **kw)
    out, toks = [np.asarray(logits[:, -1])], [np.asarray(logits[:, -1]).argmax(-1)]
    for _ in range(steps - 1):
        logits, cache = fwd(params, jnp.asarray(toks[-1][:, None]), cache)
        out.append(np.asarray(logits[:, -1]))
        toks.append(out[-1].argmax(-1))
    return np.stack(out, 1), np.stack(toks, 1)


@pytest.fixture(scope="module")
def cases():
    """Per variant: the port case tuple and the JAX outputs."""
    rng = np.random.default_rng(0)
    out = []
    for i, (name, arch, fields) in enumerate(_variants()):
        jcfg = C.with_fields(jconfigs.get_smoke(arch), **fields)
        tcfg = C.with_fields(tconfigs.get_smoke(arch), **fields)
        params = jax.jit(lambda k: jlm.init_lm(k, jcfg, tp=1)[0])(jax.random.PRNGKey(i))
        tree = jax.tree.map(np.asarray, params)
        tokens = rng.integers(0, jcfg.vocab, (4, 8)).astype(np.int32)
        vision = (rng.standard_normal((4, jcfg.n_vision_tokens, jcfg.d_model)).astype(np.float32)
                  if jcfg.n_vision_tokens else None)
        kw = {"vision_embeds": jnp.asarray(vision)} if vision is not None else {}
        logits, _ = jax.jit(lambda p, t, **k: jlm.apply_lm(p, jcfg, None, t, **k))(
            params, jnp.asarray(tokens), **kw)
        want = {"logits": np.asarray(logits)}
        want["step_logits"], want["tokens"] = _jax_greedy(jcfg, params, tokens, STEPS, vision)
        out.append((name, (tcfg, tree, tokens.astype(np.int64), STEPS, vision), want))
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def world(request, cases):
    data, model = request.param
    return request.param, tmesh.spawn(C.lm_cases, data, model, device="cpu",
                                      args=([c[1] for c in cases],))


@pytest.mark.parametrize("variant", [v[0] for v in _variants()])
def test_sharded_apply_lm_matches_jax(world, cases, variant):
    _, results = world
    i = [c[0] for c in cases].index(variant)
    want = cases[i][2]
    per_case = [r[i] for r in results]
    np.testing.assert_allclose(C.collect(per_case, "logits"), want["logits"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(C.collect(per_case, "step_logits"), want["step_logits"],
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(C.collect(per_case, "tokens"), want["tokens"])


_JAX_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np, jax, jax.numpy as jnp
    from repro import configs
    from repro.launch.mesh import activate_mesh
    from repro.models import lm
    from repro.serving import quantized_lm as q
    cfg = configs.get_smoke("deepseek-67b")
    params = jax.jit(lambda k: lm.init_lm(k, cfg, tp=1)[0])(jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab, (4, 8)), jnp.int32)
    qp = q.quantize_dense_lm(params, cfg)
    want = np.asarray(lm.apply_lm(params, cfg, None, toks)[0])
    qwant = np.asarray(q.apply_quantized_lm(qp, cfg, None, toks)[0])
    for d, m in ((1, 2), (2, 2), (1, 4), (2, 1)):
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
        with activate_mesh(mesh):
            got = np.asarray(lm.apply_lm(params, cfg, mesh, toks)[0])
            print("dense", d, m, float(np.abs(got - want).max()))
            if m <= 2:
                qgot = np.asarray(q.apply_quantized_lm(qp, cfg, mesh, toks)[0])
                print("w4a8", d, m, float(np.abs(qgot - qwant).max()))
""")


def test_jax_functions_on_a_forced_four_device_mesh():
    """The reference's sharded functions equal their ``mesh=None`` output
    on a 4-device CPU mesh with automatic axes (a subprocess: the device
    count is fixed when JAX starts)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", _JAX_MESH], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln.split() for ln in out.stdout.splitlines() if ln.startswith(("dense", "w4a8"))]
    assert len(lines) == 4 + 3, out.stdout
    for kind, d, m, diff in lines:
        assert float(diff) <= 1e-5, (kind, d, m, diff)
