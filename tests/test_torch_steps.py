"""The launch layer of the port against the JAX package, with no XLA
compile: ``launch.steps.input_specs`` on the 1 x 1 mesh of
``tests/test_launch.py`` (every arch x kind), ``abstract_model`` /
``abstract_cache`` and their specs against ``jax.eval_shape`` of the
reference's at tp 16 for every full config, the quantized trees'
abstract shapes, ``param_counts`` / ``model_flops`` /
``NAMED_VARIANTS`` equal to the reference's, and one dry-run cell per
family on the meta 16 x 16 mesh whose depth-1 / depth-2 extrapolation
equals its full trace (every layer is traced, so for these homogeneous
stacks exactly: FLOPs, bytes and each collective kind's calls and bytes).
The dry-run's collectives against a real gloo world's are held in
``tests/test_torch_tp.py``, inside its worlds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config, get_smoke as jget_smoke
from repro.launch import dryrun as jdryrun
from repro.launch import steps as jsteps
from repro.launch.mesh import make_cpu_mesh as jmake_cpu_mesh
from repro.models.common import SHAPES as JSHAPES, ShapeConfig as JShapeConfig
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun, perf, steps
from repro_torch.launch.mesh import make_cpu_mesh, make_mesh
from repro_torch.models import convert, lm
from repro_torch.models.common import SHAPES, Family, ShapeConfig
from repro_torch.serving import quantized_lm as qlm

JMESH = jmake_cpu_mesh()
SMALL = {k: (ShapeConfig(k[0], 32, 2, k), JShapeConfig(k[0], 32, 2, k))
         for k in ("train", "prefill", "decode")}
TP = 16
CACHE_BATCH, CACHE_S = 32, 128
# one full-width decode cell per family for the calibration check
FAMILY_CELLS = ["qwen3-8b", "moonshot-v1-16b-a3b", "mamba2-1.3b", "zamba2-7b",
                "internvl2-1b", "whisper-large-v3"]


def _spec(s):
    """A PartitionSpec as the port's tuple."""
    return tuple(s)


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _flat_specs(tree, prefix=()):
    """{path: spec tuple} of a port spec tree in the reference's layout."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree)}


def _flat_jax_specs(tree):
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda s: isinstance(s, P))
    return {tuple(k.key for k in path): _spec(s) for path, s in leaves}


def _flat_shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, prefix + (k,)))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    return {}


def _flat_jax_shapes(tree):
    return {tuple(k.key for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _port_reference_layout(tree, cfg):
    """A port params tree (meta tensors) in the reference's stacked layout,
    the MoE experts split as the reference stores them at tp 16."""
    if cfg.family is Family.MOE:
        split = lm.L.moe_ff_split(cfg, TP)
        tree = dict(tree, layers=[
            dict(lp, moe={k: v if k == "router" else lm.split_experts(v, k, cfg.n_experts, split)
                          for k, v in lp["moe"].items()}) for lp in tree["layers"]])
    return convert.to_reference(tree, cfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_the_reference(arch, kind):
    tshape, jshape = SMALL[kind]
    structs, specs = steps.input_specs(tconfigs.get_smoke(arch), tshape, make_cpu_mesh())
    jstructs, jshard = jsteps.input_specs(jget_smoke(arch), jshape, JMESH)
    assert set(structs) == set(jstructs) == set(specs) == set(jshard)
    for name, (shape, dtype) in structs.items():
        assert shape == tuple(jstructs[name].shape)
        assert str(dtype).split(".")[-1] == str(jstructs[name].dtype)
        assert specs[name] == _spec(jshard[name].spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_model_matches_the_reference(arch):
    """Every full config at tp 16: the port's abstract params, in the
    reference's stacked layout, have the reference's shapes and dtypes,
    and its specs are the reference's."""
    cfg = tconfigs.get_config(arch)
    aparams, specs = steps.abstract_model(cfg, TP)
    assert all(t.device.type == "meta" for t in tree_leaves(aparams))
    jparams, jspecs = jsteps.abstract_model(jget_config(arch), TP)
    assert _flat_shapes(_port_reference_layout(aparams, cfg)) == _flat_jax_shapes(jparams)
    assert _flat_specs(convert.specs_to_reference(specs, cfg)) == _flat_jax_specs(jspecs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_cache_matches_the_reference(arch):
    cfg = tconfigs.get_config(arch)
    cache = steps.abstract_cache(cfg, CACHE_BATCH, CACHE_S, TP)
    jcache = jsteps.abstract_cache(jget_config(arch), CACHE_BATCH, CACHE_S, TP)
    assert _flat_shapes(cache) == {k: v for k, v in _flat_jax_shapes(jcache).items()
                                   if k != ("length",)}
    ba = steps.batch_axes(make_mesh("meta", 16, 16), CACHE_BATCH)
    assert _flat_specs(lm.cache_specs(cfg, TP, ba)) == _flat_jax_specs(
        jsteps._cache_specs(jget_config(arch), TP, ba))


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-67b", "moonshot-v1-16b-a3b",
                                  "grok-1-314b"])
def test_abstract_quantized_matches_the_reference(arch):
    """The W4A8 trees' packed shapes and specs (dense: W4A8 + LRU target;
    MoE: experts stacked as the reference stores them at tp 16)."""
    from repro.serving import quantized_lm as jq

    cfg, jcfg = tconfigs.get_config(arch), jget_config(arch)
    if cfg.family is Family.MOE:
        tree, specs = qlm.abstract_quantized_moe(cfg, TP)
        jtree, jspecs = jq.abstract_quantized_moe(jcfg, TP)
    else:
        tree, specs = qlm.abstract_quantized(cfg, TP)
        jtree, jspecs = jq.abstract_quantized(jcfg, TP)
    assert _flat_shapes(convert.to_reference(tree, cfg)) == _flat_jax_shapes(jtree)
    assert _flat_specs(convert.specs_to_reference(specs, cfg)) == _flat_jax_specs(jspecs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops(arch):
    cfg, jcfg = tconfigs.get_config(arch), jget_config(arch)
    assert steps.param_counts(cfg) == jsteps.param_counts(jcfg)
    for name, shape in SHAPES.items():
        assert dryrun.model_flops(cfg, shape) == jdryrun.model_flops(jcfg, JSHAPES[name])


def test_named_variants_equal_the_reference():
    from repro.launch.perf import NAMED_VARIANTS as J

    assert perf.NAMED_VARIANTS == J


@pytest.mark.parametrize("arch", FAMILY_CELLS)
def test_dryrun_cell_and_calibration(arch):
    """A full-width decode cell on the meta 16 x 16 mesh: ok, the memory
    and roofline records filled, and the depth-1 / depth-2 extrapolation
    equal to the full trace."""
    rec = dryrun.dryrun_cell(arch, "decode_32k")
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    raw, corr = rec["raw"], rec["corrected"]
    assert raw["flops"] > 0 and raw["flops"] == corr["flops"]
    assert raw["bytes"] > 0 and raw["bytes"] == corr["bytes"]
    assert set(raw["collectives"]) == set(corr["collectives"])
    for kind, c in raw["collectives"].items():
        assert (c["count"], c["bytes"]) == (corr["collectives"][kind]["count"],
                                           corr["collectives"][kind]["bytes"])
    r = rec["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < r["useful_flops_ratio"]
    assert all(rec["memory"][k] > 0 for k in ("argument_bytes", "output_bytes", "temp_bytes"))
