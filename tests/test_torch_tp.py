"""The sharded bf16/f32 forward of the port (``lm.apply_lm(..., mesh=)``)
against the JAX package's ``apply_lm`` without a mesh, on the same numpy
weights, over local gloo worlds of CPU ranks at meshes (1, 2), (2, 2),
(1, 4) and (2, 1): tensor parallelism with virtual KV heads (n_kv 2 at tp
4), a head count the model axis does not divide (attention replicated),
Megatron sequence sharding on and off and once per block, FSDP, the VLM's
image tokens and the MoE family's dense combine over gathered experts.
One world per mesh runs every case, and the ``launch.steps`` cells whose
collectives the dry-run's meta trace must reproduce
(``test_meta_collectives_match_the_world``).

Tolerances (float32 smoke configs): logits within 1e-5 of the JAX
function's (observed <= 4e-6: the sharded sums and the attention's head
groups run in other orders); the greedy tokens of a prefill and three
decode steps over the dense cache equal, their step logits within 1e-5.
The same holds for the SSM (mamba2), hybrid (zamba2) and audio (whisper)
families, whose blocks regroup their contiguous shards per layer (one
all-gather of the in-projection, the gated norm's sum of squares
all-reduced), and for the dense int8 KV cache (``kv_quant``; its decode
steps run the reference's bfloat16 math on the CPU).

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
from repro.models import whisper as jwhisper
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models.common import ShapeConfig

ATOL = 1e-5
MESHES = [(1, 2), (2, 2), (1, 4), (2, 1)]
CELL_MESHES = [(1, 2)]  # the world that also runs the launch cells
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
        ("mamba2", "mamba2-1.3b", {}),  # SSM: 8 heads, 276 in-projection columns at tp 2
        ("zamba2", "zamba2-7b", {}),  # hybrid: 2 groups + 1 tail block, one shared attention
        ("whisper", "whisper-large-v3", {}),  # encoder-decoder, 16 frames
        ("deepseek-kvq8", "deepseek-67b", {"kv_quant": True}),  # dense int8 KV cache
    ]


def _jax_apply(jcfg):
    if jcfg.family.value == "audio":
        return lambda p, t, **k: jwhisper.apply_whisper(p, jcfg, None, t, **k)
    return lambda p, t, **k: jlm.apply_lm(p, jcfg, None, t, **k)


def _jax_greedy(jcfg, params, tokens, steps, extra):
    kw = {k: jnp.asarray(v) for k, v in extra.items()}
    vision = extra.get("vision_embeds")
    s0 = tokens.shape[1] + (vision.shape[1] if vision is not None else 0)
    if jcfg.family.value == "audio":
        cache = jwhisper.init_whisper_cache(jcfg, tokens.shape[0], s0 + steps, tp=1)
    else:
        cache = jlm.init_cache(jcfg, tokens.shape[0], s0 + steps, tp=1)
    apply = _jax_apply(jcfg)
    fwd = jax.jit(lambda p, t, c, **k: apply(p, t, cache=c, **k))
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
        init = jwhisper.init_whisper if jcfg.family.value == "audio" else jlm.init_lm
        params = jax.jit(lambda k: init(k, jcfg, tp=1)[0])(jax.random.PRNGKey(i))
        tree = jax.tree.map(np.asarray, params)
        tokens = rng.integers(0, jcfg.vocab, (4, 8)).astype(np.int32)
        extra = {}
        if jcfg.n_vision_tokens:
            extra["vision_embeds"] = rng.standard_normal(
                (4, jcfg.n_vision_tokens, jcfg.d_model)).astype(np.float32)
        if jcfg.family.value == "audio":
            extra["frames"] = rng.standard_normal(
                (4, jcfg.n_audio_frames, jcfg.d_model)).astype(np.float32)
        kw = {k: jnp.asarray(v) for k, v in extra.items()}
        logits, _ = jax.jit(_jax_apply(jcfg))(params, jnp.asarray(tokens), **kw)
        want = {"logits": np.asarray(logits)}
        want["step_logits"], want["tokens"] = _jax_greedy(jcfg, params, tokens, STEPS, extra)
        out.append((name, (tcfg, tree, tokens.astype(np.int64), STEPS, extra or None), want))
    return out


def _cells():
    """(name, cfg, shape, quant): smoke cells of ``launch.steps.build_cell``
    whose collectives the worlds log, one per family and kind."""
    def shape(kind):
        return ShapeConfig(kind, 16, 4, kind)

    kvq8 = C.with_fields(tconfigs.get_smoke("deepseek-67b"), kv_quant=True)
    return [("mamba2-decode", tconfigs.get_smoke("mamba2-1.3b"), shape("decode"), None),
            ("zamba2-prefill", tconfigs.get_smoke("zamba2-7b"), shape("prefill"), None),
            ("whisper-train", tconfigs.get_smoke("whisper-large-v3"), shape("train"), None),
            ("qwen3-fsdp-train", C.with_fields(tconfigs.get_smoke("qwen3-8b"), fsdp=True),
             shape("train"), None),
            ("moonshot-decode", tconfigs.get_smoke("moonshot-v1-16b-a3b"), shape("decode"), None),
            ("kvq8-decode", kvq8, shape("decode"), None),
            ("w4a8+kvq8-decode", C.with_fields(tconfigs.get_smoke("qwen3-8b"), kv_quant=True),
             shape("decode"), "w4a8")]


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def world(request, cases):
    data, model = request.param
    cells = [c[1:] for c in _cells()] if request.param in CELL_MESHES else []
    return request.param, tmesh.spawn(C.tp_world, data, model, device="cpu",
                                      args=([c[1] for c in cases], cells))


@pytest.mark.parametrize("variant", [v[0] for v in _variants()])
def test_sharded_apply_lm_matches_jax(world, cases, variant):
    _, results = world
    i = [c[0] for c in cases].index(variant)
    want = cases[i][2]
    per_case = [r["lm"][i] for r in results]
    np.testing.assert_allclose(C.collect(per_case, "logits"), want["logits"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(C.collect(per_case, "step_logits"), want["step_logits"],
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(C.collect(per_case, "tokens"), want["tokens"])


@pytest.mark.parametrize("world", CELL_MESHES, indirect=True, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("cell", [c[0] for c in _cells()])
def test_meta_collectives_match_the_world(world, cell):
    """The dry-run's trace of a cell on the meta mesh of the world's shape
    logs the collectives (kind, calls, bytes) every rank of the real gloo
    world (1, 2) ran for the same cell."""
    (data, model), results = world
    i = [c[0] for c in _cells()].index(cell)
    _, cfg, shape, quant = _cells()[i]
    meta = C.cell_comm(tmesh.make_mesh("meta", data, model), [(cfg, shape, quant)])[0]
    assert meta.get("calls", 0) > 0
    for r in results:
        assert r["cells"][i] == meta


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
