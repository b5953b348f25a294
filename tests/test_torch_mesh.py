"""The port's device mesh over torch.distributed and its spec trees.

A (2, 2) gloo world of CPU ranks checks the mesh itself: coordinates,
the per-axis groups, every collective the sharded paths use (all-reduce
sum and max, all-gather, reduce-scatter, all-to-all, int32 sums) and the
Megatron pairs' backward (all-reduce / identity, identity / all-reduce,
all-gather / reduce-scatter, reduce-scatter / all-gather, split /
all-gather, gather / slice).  The spec trees, the batch-axis rule, the
virtual KV head counts and the ZeRO-1 moment specs equal the JAX
package's (PartitionSpecs as tuples, the port's per-layer trees stacked
with ``convert.specs_to_reference``) for every attention-family smoke
config at tp 1, 2 and 4."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax

import torch_mesh_cases as C
from repro import configs as jconfigs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.serving import quantized_lm as jq
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import convert
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models.common import Family
from repro_torch.optim import optimizer_specs
from repro_torch.serving import quantized_lm as tq

ATTN = [a for a in jconfigs.ARCH_IDS
        if jconfigs.get_smoke(a).family in (Family.DENSE, Family.VLM, Family.MOE)]


def _tuples(tree):
    """A JAX spec tree with its PartitionSpec leaves as tuples."""
    return jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))


def _jax_specs(arch, tp, **fields):
    cfg = C.with_fields(jconfigs.get_smoke(arch), **fields)
    return _tuples(jlm.init_lm(jax.random.PRNGKey(0), cfg, tp)[1])


@pytest.fixture(scope="module")
def world():
    return tmesh.spawn(C.collectives_case, 2, 2, device="cpu")


def test_mesh_coordinates_and_backend(world):
    for r in world:
        assert r["shape"] == {"data": 2, "model": 2}
        assert r["coords"] == {"data": r["rank"] // 2, "model": r["rank"] % 2}
        assert (r["data_index"], r["model_index"]) == (r["rank"] // 2, r["rank"] % 2)
        assert (r["backend"], r["transport"]) == ("gloo", "gloo-cpu")
        assert r["comm"] == {"calls": 1, "all_reduce_calls": 1, "bytes": 32,
                             "all_reduce_bytes": 32, "seconds": r["comm"]["seconds"]}


def test_collectives_values(world):
    for r in world:
        data, mi = r["coords"]["data"], r["coords"]["model"]
        row = [1 + 2 * data, 2 + 2 * data]  # the model group's rank values
        assert r["sum_model"] == sum(row)
        assert r["max_all"] == 4
        assert r["gather_model"] == [row[0], row[0], row[1], row[1]]
        col = [1 + mi, 3 + mi]  # the data group's
        assert r["rs_data"] == [[sum(col)] * 2] * 2
        peers = [2 * data, 2 * data + 1]
        assert r["a2a_model"] == [[2 * mi + 100 * p, 2 * mi + 1 + 100 * p] for p in peers]
        assert r["int32_sum"] == 2 ** 29


def test_collectives_backward_pairs(world):
    for r in world:
        data, mi = r["coords"]["data"], r["coords"]["model"]
        row = [1 + 2 * data, 2 + 2 * data]
        assert r["g_ar"] == [[1.0] * 2] * 2
        assert r["g_copy"] == [[float(sum(row))] * 2] * 2
        want = 2 * np.arange(12, dtype=np.float32).reshape(4, 3)[2 * mi:2 * mi + 2]
        np.testing.assert_array_equal(np.array(r["g_gather"]), want)
        peer_rows = [[float(row[0])] * 3] * 2 + [[float(row[1])] * 3] * 2
        assert r["g_rs"] == peer_rows
        assert r["g_split"] == peer_rows
        assert r["g_rep"] == [[2.0] * 3] * 2


def test_one_device_mesh_and_its_limits(monkeypatch):
    m = tmesh.make_cpu_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.size == 1 and m.device.type == "cpu"
    assert m.all_reduce(torch.ones(2), "model").tolist() == [1.0, 1.0]
    with pytest.raises(RuntimeError, match="needs a process group of 4 ranks"):
        tmesh.make_cpu_mesh(2, 2)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_production_mesh()
    assert tmesh.backend_for("cpu", 4) == ("gloo", "gloo-cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.backend_for("cuda", 2) == ("gloo", "gloo-shared-card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert tmesh.backend_for("cuda", 8) == ("nccl", "nccl")


def test_mesh_checkpoint_needs_a_spec_for_every_leaf(tmp_path):
    """With a mesh the store cuts or gathers every leaf by its spec: a leaf
    without a spec (or a spec without a leaf) raises instead of passing a
    shard off as the whole array."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    tree = {"a": torch.arange(4.0).reshape(2, 2), "b": {"c": torch.ones(3)}}
    save_checkpoint(str(tmp_path), 0, tree)
    m = tmesh.make_cpu_mesh()
    _, back, _ = load_checkpoint(str(tmp_path), 0, device="cpu", mesh=m,
                                 specs={"a": ("model", None), "b": {"c": (None,)}})
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"]["c"], tree["b"]["c"])
    for specs in ({"a": ("model", None)},
                  {"a": ("model", None), "b": {"c": (None,), "d": (None,)}}):
        with pytest.raises(ValueError, match="the specs do not match the tree"):
            load_checkpoint(str(tmp_path), 0, device="cpu", mesh=m, specs=specs)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", ATTN)
def test_param_specs_match_jax(arch, tp):
    tcfg = tconfigs.get_smoke(arch)
    assert convert.specs_to_reference(tlm.param_specs(tcfg, tp), tcfg) == _jax_specs(arch, tp)
    assert tL.kv_store_heads(tcfg, tp) == jL.kv_store_heads(jconfigs.get_smoke(arch), tp)
    assert tL.attn_tp_enabled(tcfg, tp) == jL.attn_tp_enabled(jconfigs.get_smoke(arch), tp)


@pytest.mark.parametrize("arch", ["qwen3-8b", "moonshot-v1-16b-a3b"])
def test_fsdp_specs_match_jax(arch):
    tcfg = C.with_fields(tconfigs.get_smoke(arch), fsdp=True)
    assert convert.specs_to_reference(tlm.param_specs(tcfg, 2), tcfg) == \
        _jax_specs(arch, 2, fsdp=True)


@pytest.mark.parametrize("fsdp", [False, True])
def test_quantized_specs_match_jax(fsdp):
    for arch, tfn, jfn in (("qwen3-8b", tq.quantized_param_specs, jq.quantized_param_specs),
                           ("moonshot-v1-16b-a3b", tq.quantized_moe_param_specs,
                            jq.quantized_moe_param_specs)):
        tcfg = C.with_fields(tconfigs.get_smoke(arch), fsdp=fsdp)
        jcfg = C.with_fields(jconfigs.get_smoke(arch), fsdp=fsdp)
        assert convert.specs_to_reference(tfn(tcfg), tcfg) == _tuples(jfn(jcfg))


@pytest.mark.parametrize("data", [1, 2, 4])
@pytest.mark.parametrize("arch", ["deepseek-67b", "llama3-405b", "moonshot-v1-16b-a3b"])
def test_optimizer_specs_match_jax(arch, data):
    """ZeRO-1 moments: the largest free dimension the data axis divides."""
    tcfg, jcfg = tconfigs.get_smoke(arch), jconfigs.get_smoke(arch)
    params, jspecs = jlm.init_lm(jax.random.PRNGKey(0), jcfg, 2)
    want = _tuples(jadamw.optimizer_specs(jspecs, params, zero1_axis="data", axis_size=data))
    full = tlm.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    if tcfg.family is Family.MOE:  # the moments of the (E * split) stacks
        split = tL.moe_ff_split(tcfg, 2)
        full["layers"] = [dict(lp, moe={k: tlm.split_experts(v, k, tcfg.n_experts, split)
                                        if k != "router" else v for k, v in lp["moe"].items()})
                          for lp in full["layers"]]
    got = optimizer_specs(tlm.param_specs(tcfg, 2), full, zero1_axis="data", axis_size=data)
    assert {"mu": convert.specs_to_reference(got["mu"], tcfg),
            "nu": convert.specs_to_reference(got["nu"], tcfg), "count": ()} == want
    assert optimizer_specs(tlm.param_specs(tcfg, 2), full, zero1_axis=None)["mu"] == \
        tlm.param_specs(tcfg, 2)


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 8, 12])
@pytest.mark.parametrize("shape", [{"data": 2, "model": 2}, {"data": 4, "model": 1},
                                   {"pod": 2, "data": 2, "model": 4}])
def test_pick_batch_axes_matches_jax(shape, batch):
    mesh = types.SimpleNamespace(shape=shape)
    assert tL.pick_batch_axes(mesh, batch) == jL.pick_batch_axes(mesh, batch)
    assert tlm.batch_axes_for(mesh, batch) == jlm.batch_axes_for(mesh, batch)
    assert tlm.batch_axes_for(mesh) == jlm.batch_axes_for(mesh)


def test_chip_smoke_mesh_phases_dry_run():
    """chip_smoke.py's mesh phases at smoke size on the CPU
    (``--cpu-dry-run``): their own checks (bitwise W4A8 on (1, 2), rows,
    the MoE layer's bounds, the launch cells against one device, the
    dry-run's collectives against the world's, the training path's
    losses, restored bits and elastic run) pass on gloo worlds of CPU
    ranks."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--cpu-dry-run"],
                         capture_output=True, text=True, timeout=600, cwd=root,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path)))
    assert run.returncode == 0, run.stderr[-3000:]
    for phase in ("tp_path", "tp_bf16_path", "ep_layer", "ep_path", "ep_w4a8_path",
                  "mamba2_cell_path", "w4a8_kvq8_cell_path", "dryrun_path",
                  "mesh_train_path"):
        assert f'"phase": "{phase}"' in run.stdout
    assert '"ok": true' not in run.stdout  # a dry run prints no result line
