"""Training driver: ``python -m repro_torch.launch.train --arch <id> [--smoke]
[--device cuda|cpu]`` (torch counterpart of repro/launch/train.py).

config -> mesh -> init (or carried-across params) -> the synthetic data
stream -> an eager step (``loss_fn``, backward, AdamW under
``linear_warmup_cosine(step, 20, 2000)``) -> async checkpoints every
``ckpt_every`` steps -> ``restore()`` from the latest.  Checkpoints hold
``{"params", "opt"}`` in the reference's layer-stacked layout
(``models.convert.to_reference``), so the JAX ``Trainer`` restores what
this one saved and the other way round.  It runs on the card unless
``--device cpu`` (or ``device="cpu"``) is given, and never falls back to
the CPU when the card is missing.

On a mesh of more than one rank (every family) every rank runs
the Trainer: the params are initialized whole from the seed and cut to the
rank's shard (``lm.param_specs``), each data rank takes its rows of the
global batch (``SyntheticLMDataset.host_slice``), the step is the sharded
forward and backward (tensor parallelism, Megatron sequence sharding,
FSDP under ``cfg.fsdp``) and ``adamw_update_sharded`` with ZeRO-1 exactly
where the reference's step uses it (``zero1 = None if cfg.fsdp else
"data"``).  Checkpoints are gathered whole and written by rank 0 in the
same format; any mesh restores them by slicing.  Only rank 0 logs.
Under torchrun with a world of 256 or 512 ranks the CLI builds the
production mesh (``--multi-pod`` for 2 x 16 x 16) and refuses another
world size; ``--smoke`` keeps one device."""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, load_checkpoint
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import prng
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.mesh import DeviceMesh, make_mesh, make_production_mesh, remesh
from repro_torch.launch.steps import param_counts
from repro_torch.models import lm
from repro_torch.models.common import Family, ModelConfig
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_init_sharded, adamw_update,
                               adamw_update_sharded, linear_warmup_cosine, optimizer_specs)

__all__ = ["Trainer", "main", "elastic_trainer"]


def _device(mesh: Optional[DeviceMesh], device) -> torch.device:
    dev = torch.device(device if device is not None else
                       (mesh.device if mesh is not None else "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the trainer runs on the card and no CUDA device is present; "
                           "pass device='cpu' (--device cpu) to train on the CPU")
    return dev


class Trainer:
    """Trainer with checkpoint-restart, on one device or on every rank of a
    mesh.  ``params`` (the port's full tree, on the trainer's device)
    replaces the seeded init, as when both packages start from one set of
    weights; on a mesh each rank cuts its shard from it."""

    def __init__(
        self,
        cfg: ModelConfig,
        mesh: Optional[DeviceMesh] = None,
        seq_len: int = 128,
        global_batch: int = 8,
        ocfg: Optional[AdamWConfig] = None,
        ckpt_dir: Optional[str] = None,
        seed: int = 0,
        params: Optional[Any] = None,
        device=None,
    ):
        self.cfg = cfg
        self.device = _device(mesh, device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.ocfg = ocfg or AdamWConfig(lr=1e-3, moment_dtype=cfg.optim_dtype)
        self.writer = self.mesh is None or self.mesh.rank == 0
        self.ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir and self.writer else None
        self.ckpt_dir = ckpt_dir
        self.data = SyntheticLMDataset(
            DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch, seed=seed))
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = lm.init_lm(gen, cfg, self.device)
        if self.mesh is None:
            self.params = params
            self.opt_state = adamw_init(self.params, self.ocfg)
        else:
            m = self.mesh
            if global_batch % m.axis_size(lm.batch_axes_for(m)):
                raise ValueError(f"global batch {global_batch} does not split over the batch "
                                 f"axes of {m.shape}")
            self.specs = lm.param_specs(cfg, m.tp)
            zero1 = None if cfg.fsdp else "data"
            self.moment_specs = optimizer_specs(self.specs, params, zero1_axis=zero1,
                                                axis_size=m.shape["data"])
            self.params = lm.shard_params(params, self.specs, m, cfg)
            self.opt_state = adamw_init_sharded(self.params, self.ocfg, self.specs,
                                                self.moment_specs, m)
        self.step = 0

    def frames(self, step: int) -> torch.Tensor:
        """The audio family's stand-in encoder input of a step: standard
        normals from ``PRNGKey(step)``, as the reference draws them (its
        float32 draw; other model dtypes take it cast)."""
        shape = (self.global_batch, self.cfg.n_audio_frames, self.cfg.d_model)
        x = torch.from_numpy(prng.normal(prng.PRNGKey(step), shape))
        return x.to(device=self.device, dtype=self.cfg.tdtype)

    def batch(self, step: int) -> torch.Tensor:
        """This rank's rows of the step's global batch."""
        m = self.mesh
        if m is None:
            rows = self.data.batch(step)
        else:
            axes = lm.batch_axes_for(m)
            rows = self.data.host_slice(step, m.axis_index(axes), m.axis_size(axes))
        return torch.from_numpy(rows).to(self.device)

    def train_step(self) -> Dict[str, torch.Tensor]:
        """One step at ``self.step`` (not advanced here): loss, gradients,
        the AdamW update.  Returns ``{"loss", "grad_norm"}`` as 0-d
        tensors (on a mesh, the global batch's)."""
        tokens = self.batch(self.step)
        params = tree_map(lambda t: t.detach().requires_grad_(), self.params)
        kw = ({"frames": lm.local_rows(self.frames(self.step), self.mesh)}
              if self.cfg.family is Family.AUDIO else {})
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        loss = lm.loss_fn(params, self.cfg, tokens, **kw)
        grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))
        lscale = linear_warmup_cosine(self.step, 20, 2000)
        if self.mesh is None:
            self.params, self.opt_state, m = adamw_update(params, grads, self.opt_state,
                                                          self.ocfg, lscale)
        else:
            self.params, self.opt_state, m = adamw_update_sharded(
                params, grads, self.opt_state, self.ocfg, lscale, self.mesh, self.specs,
                self.moment_specs, lm.batch_axes_for(self.mesh), self.cfg.grad_barrier,
                self.cfg.grad_constraint)
        return {"loss": loss.detach(), **m}

    def full_state(self):
        """(params, mu, nu) whole on every rank (gathered on a mesh)."""
        st = self.opt_state
        if self.mesh is None:
            return self.params, st["mu"], st["nu"]
        m = self.mesh

        def gather(tree, specs):
            return lm.map_specs(tree, specs, lambda t, sp: lm.unshard_leaf(t, sp, m))

        return (gather(self.params, self.specs), gather(st["mu"], self.moment_specs["mu"]),
                gather(st["nu"], self.moment_specs["nu"]))

    def checkpoint_tree(self) -> Dict[str, Any]:
        """``{"params", "opt"}`` whole, in the reference's layout (a
        collective on a mesh)."""
        params, mu, nu = self.full_state()
        return {"params": to_reference(params, self.cfg),
                "opt": {"mu": to_reference(mu, self.cfg), "nu": to_reference(nu, self.cfg),
                        "count": self.opt_state["count"]}}

    def load_state(self, tree: Dict[str, Any]) -> None:
        """Take params and optimizer state from a ``checkpoint_tree()``-shaped
        tree (the reference's layout, whole, on this trainer's device); on a
        mesh each rank keeps its slices."""
        opt = tree["opt"]
        params = from_reference(tree["params"], self.cfg)
        mu, nu = from_reference(opt["mu"], self.cfg), from_reference(opt["nu"], self.cfg)
        if self.mesh is not None:
            m = self.mesh
            params = lm.shard_params(params, self.specs, m, self.cfg)
            mu = lm.map_specs(mu, self.moment_specs["mu"], lambda t, sp: lm.shard_leaf(t, sp, m))
            nu = lm.map_specs(nu, self.moment_specs["nu"], lambda t, sp: lm.shard_leaf(t, sp, m))
        self.params = params
        self.opt_state = {"mu": mu, "nu": nu, "count": opt["count"]}

    def restore(self) -> bool:
        """Load the latest checkpoint, if any, and continue after it."""
        if self.mesh is not None:
            self.mesh.barrier()
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            return False
        step, tree, _ = load_checkpoint(self.ckpt_dir, device=self.device)
        self.load_state(tree)
        self.step = step + 1
        return True

    def save(self, step: int) -> None:
        """Checkpoint ``step``: gathered on every rank, written by rank 0."""
        tree = self.checkpoint_tree()
        if self.ckpt is not None:
            self.ckpt.save(step, tree)

    def run(self, steps: int, ckpt_every: int = 50, log_every: int = 10):
        history = []
        for _ in range(steps):
            loss = float(self.train_step()["loss"])
            history.append({"step": self.step, "loss": loss})
            if self.step % log_every == 0 and self.writer:
                print(f"step {self.step:5d} loss {loss:.4f}", flush=True)
            if self.ckpt_dir and self.step % ckpt_every == 0:
                self.save(self.step)
            self.step += 1
        if self.ckpt:
            self.ckpt.wait()
        if self.mesh is not None:
            self.mesh.barrier()
        return history


def elastic_trainer(cfg: ModelConfig, mesh: DeviceMesh, ft_cfg, model: int = 1,
                    failure_source=None, min_hosts: int = 1, **trainer_kw):
    """An ``ElasticTrainer`` over this rank's world: a host is ``model``
    ranks (one row of the data axis), the fleet ``mesh.shape["data"]``
    hosts.  When a host is lost the world is re-formed as (hosts - 1) x
    model (``launch.mesh.remesh``; the ranks past it leave, their
    ``run`` returning None), a Trainer is built on the new mesh and
    restored from the last checkpoint, which rank 0 writes and every rank
    reads after a barrier."""
    from repro_torch.runtime import ElasticTrainer

    state = {"mesh": mesh}

    def build(n_hosts, restore):
        m = state["mesh"]
        if m is not None and m.shape["data"] != n_hosts:
            m = state["mesh"] = remesh(m, n_hosts, model)
        if m is None:
            return None, None
        tr = Trainer(cfg, m, **trainer_kw)
        if restore is not None:
            tr.load_state(tree_map(lambda t: t.to(tr.device) if isinstance(t, torch.Tensor)
                                   else t, restore[1]))

        def step_fn(st, step):
            tr.step = step
            return st, {"loss": float(tr.train_step()["loss"])}

        return {"trainer": tr}, step_fn

    def writer():
        return state["mesh"] is not None and state["mesh"].rank == 0

    def sync():
        if state["mesh"] is not None:
            state["mesh"].barrier()

    return ElasticTrainer(ft_cfg, mesh.shape["data"], build,
                          lambda st: st["trainer"].checkpoint_tree(), failure_source,
                          min_hosts=min_hosts, device=mesh.device, writer=writer, sync=sync)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 production mesh (a torchrun world of 512)")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = _cli_mesh(args)
    pc = param_counts(cfg)
    if mesh.rank == 0:
        print(f"arch={cfg.name} params~{pc['total']/1e6:.1f}M active~{pc['active']/1e6:.1f}M "
              f"device={mesh.device} mesh={mesh.shape} backend={mesh.backend}")
    tr = Trainer(cfg, mesh, seq_len=args.seq_len, global_batch=args.batch,
                 ckpt_dir=args.ckpt_dir)
    tr.restore()
    hist = tr.run(args.steps)
    if mesh.rank == 0:
        print(f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return 0


def _cli_mesh(args) -> DeviceMesh:
    """--smoke, or no torchrun world: one device.  Else the production mesh
    (``make_production_mesh`` raises for a world other than 256 or 512)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.smoke or (world == 1 and not args.multi_pod):
        return make_mesh(args.device)
    return make_production_mesh(multi_pod=args.multi_pod or world == 512, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
