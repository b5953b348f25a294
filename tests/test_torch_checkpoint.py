"""Checkpoints across the two packages: a tree saved by either loads in the
other bit for bit (bfloat16 included, stored as its uint16 pattern with
the dtype's name, loaded by the port without ml_dtypes), the async writer
and the atomic publish, and Trainer checkpoints that each package's
Trainer restores from the other's."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.launch.mesh import make_cpu_mesh as jmake_cpu_mesh
from repro.launch.train import Trainer as JTrainer
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch.core.tree import to_numpy, tree_leaves
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import convert


def _bits(a):
    """A leaf's dtype name and raw bytes, whichever package made it."""
    if isinstance(a, torch.Tensor):
        arr, name = to_numpy(a)
    else:
        arr = np.asarray(a)
        name = arr.dtype.name
        arr = arr.view(np.uint16) if name == "bfloat16" else arr
    return name, arr.shape, arr.tobytes()


def _torch_tree():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn((3, 5), generator=g),
                   "b": torch.randn((4,), generator=g).to(torch.bfloat16),
                   "layers": {"k": torch.randn((2, 3, 2), generator=g).to(torch.bfloat16)}},
        "opt": {"mu": torch.randn((3, 5), generator=g),
                "count": torch.tensor(7, dtype=torch.int32),
                "codes": torch.arange(-4, 4, dtype=torch.int8),
                "flag": torch.tensor([True, False])},
    }


def _jax_tree():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {
        "params": {"w": jax.random.normal(k1, (3, 5)),
                   "b": jax.random.normal(k2, (4,)).astype(jnp.bfloat16),
                   "layers": {"k": jnp.arange(12, dtype=jnp.float32).reshape(2, 3, 2)
                              .astype(jnp.bfloat16)}},
        "opt": {"mu": jnp.ones((3, 5), jnp.float32), "count": jnp.asarray(7, jnp.int32),
                "codes": jnp.arange(-4, 4, dtype=jnp.int8)},
    }


def _same(a, b):
    la, lb = tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bits(x) == _bits(y)


def test_port_checkpoint_loads_in_reference(tmp_path):
    tree = _torch_tree()
    d = tckpt.save_checkpoint(str(tmp_path), 12, tree, {"note": "x"})
    assert os.path.basename(d) == "step_00000012"
    assert sorted(os.listdir(d)) == ["manifest.json", "shard_host0.npz"]
    assert jckpt.latest_step(str(tmp_path)) == 12
    step, loaded, extra = jckpt.load_checkpoint(str(tmp_path))
    assert step == 12 and extra == {"note": "x"}
    assert loaded["params"]["b"].dtype == jnp.bfloat16
    _same(tree, loaded)


def test_reference_checkpoint_loads_in_port(tmp_path):
    tree = _jax_tree()
    jckpt.save_checkpoint(str(tmp_path), 3, tree, {"note": "y"})
    step, loaded, extra = tckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert step == 3 and extra == {"note": "y"}
    assert loaded["params"]["b"].dtype == torch.bfloat16
    assert loaded["opt"]["count"].dtype == torch.int32 and int(loaded["opt"]["count"]) == 7
    _same(loaded, tree)


def test_round_trip_in_port_and_list_layout(tmp_path):
    """Lists are stored as dicts keyed by index, as the reference stores
    them."""
    tree = {"layers": [{"w": torch.ones(2)}, {"w": torch.zeros(2, dtype=torch.bfloat16)}]}
    tckpt.save_checkpoint(str(tmp_path), 0, tree)
    _, loaded, _ = tckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert set(loaded["layers"]) == {"0", "1"}
    assert torch.equal(loaded["layers"]["1"]["w"], tree["layers"][1]["w"])
    _, jl, _ = jckpt.load_checkpoint(str(tmp_path))
    assert jl["layers"]["1"]["w"].dtype == jnp.bfloat16


def test_async_checkpointer_snapshots_on_save(tmp_path):
    ck = tckpt.AsyncCheckpointer(str(tmp_path))
    x = torch.zeros(4)
    for s in (0, 5, 10):
        x.fill_(s)
        ck.save(s, {"x": x})
    x.fill_(-1)  # after save returned: the snapshots must not see this
    ck.close()
    assert tckpt.latest_step(str(tmp_path)) == 10
    for s in (0, 5, 10):
        _, t, _ = tckpt.load_checkpoint(str(tmp_path), s, device="cpu")
        assert torch.equal(t["x"], torch.full((4,), float(s)))
    _, t, _ = jckpt.load_checkpoint(str(tmp_path), 5)
    assert float(t["x"][0]) == 5.0


def test_partial_write_is_not_a_checkpoint(tmp_path):
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert tckpt.latest_step(str(tmp_path)) is None
    assert tckpt.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path), device="cpu")
    tckpt.save_checkpoint(str(tmp_path), 2, {"x": torch.ones(1)})
    assert tckpt.latest_step(str(tmp_path)) == 2


def test_trainer_checkpoints_cross_packages(tmp_path):
    """A bfloat16 mamba2 smoke model: the port's Trainer saves after one
    step and the reference Trainer restores the same bits; the reference
    Trainer saves and the port's restores them, continuing one step
    later."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("mamba2-1.3b"), dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_smoke("mamba2-1.3b"), dtype="bfloat16")
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    tt = ttrain.Trainer(tcfg, tmesh.make_cpu_mesh(), seq_len=8, global_batch=2, ckpt_dir=a)
    tt.run(steps=1, ckpt_every=1, log_every=100)
    jt = JTrainer(jcfg, jmake_cpu_mesh(), seq_len=8, global_batch=2, ckpt_dir=a)
    assert jt.restore() and jt.step == 1
    saved = tt.checkpoint_tree()
    assert tree_leaves(saved["params"])[0].dtype == torch.bfloat16
    _same(saved["params"], jt.params)
    _same(saved["opt"], jt.opt_state)

    jt.ckpt = jckpt.AsyncCheckpointer(b)
    jt.ckpt.save(7, {"params": jt.params, "opt": jt.opt_state})
    jt.ckpt.wait()
    back = ttrain.Trainer(tcfg, tmesh.make_cpu_mesh(), seq_len=8, global_batch=2, ckpt_dir=b)
    assert back.restore() and back.step == 8
    _same(convert.to_reference(back.params, tcfg), jt.params)
    assert int(back.opt_state["count"]) == int(jt.opt_state["count"]) == 1
