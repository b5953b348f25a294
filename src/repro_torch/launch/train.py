"""Training driver: ``python -m repro_torch.launch.train --arch <id> [--smoke]
[--device cuda|cpu]`` (torch counterpart of repro/launch/train.py, one
device).

config -> one-device mesh -> init (or carried-across params) -> the
synthetic data stream -> an eager step (``loss_fn``, backward, AdamW under
``linear_warmup_cosine(step, 20, 2000)``) -> async checkpoints every
``ckpt_every`` steps -> ``restore()`` from the latest.  Checkpoints hold
``{"params", "opt"}`` in the reference's layer-stacked layout
(``models.convert.to_reference``), so the JAX ``Trainer`` restores what
this one saved and the other way round.  It runs on the card unless
``--device cpu`` (or ``device="cpu"``) is given, and never falls back to
the CPU when the card is missing."""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, load_checkpoint
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import prng
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.mesh import DeviceMesh, make_mesh, make_production_mesh
from repro_torch.launch.steps import param_counts
from repro_torch.models import lm
from repro_torch.models.common import Family, ModelConfig
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, linear_warmup_cosine

__all__ = ["Trainer", "main"]


def _device(mesh: Optional[DeviceMesh], device) -> torch.device:
    dev = torch.device(device if device is not None else
                       (mesh.device if mesh is not None else "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the trainer runs on the card and no CUDA device is present; "
                           "pass device='cpu' (--device cpu) to train on the CPU")
    return dev


class Trainer:
    """One-device trainer with checkpoint-restart.  ``params`` (the port's
    tree, on the trainer's device) replaces the seeded init, as when both
    packages start from one set of weights."""

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
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.ocfg = ocfg or AdamWConfig(lr=1e-3, moment_dtype=cfg.optim_dtype)
        self.ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        self.ckpt_dir = ckpt_dir
        self.data = SyntheticLMDataset(
            DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch, seed=seed))
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = lm.init_lm(gen, cfg, self.device)
        self.params = params
        self.opt_state = adamw_init(self.params, self.ocfg)
        self.step = 0

    def frames(self, step: int) -> torch.Tensor:
        """The audio family's stand-in encoder input of a step: standard
        normals from ``PRNGKey(step)``, as the reference draws them (its
        float32 draw; other model dtypes take it cast)."""
        shape = (self.global_batch, self.cfg.n_audio_frames, self.cfg.d_model)
        x = torch.from_numpy(prng.normal(prng.PRNGKey(step), shape))
        return x.to(device=self.device, dtype=self.cfg.tdtype)

    def train_step(self) -> Dict[str, torch.Tensor]:
        """One step at ``self.step`` (not advanced here): loss, gradients,
        the AdamW update.  Returns ``{"loss", "grad_norm"}`` as 0-d
        tensors."""
        tokens = torch.from_numpy(self.data.batch(self.step)).to(self.device)
        params = tree_map(lambda t: t.detach().requires_grad_(), self.params)
        kw = {"frames": self.frames(self.step)} if self.cfg.family is Family.AUDIO else {}
        loss = lm.loss_fn(params, self.cfg, tokens, **kw)
        grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))
        lscale = linear_warmup_cosine(self.step, 20, 2000)
        self.params, self.opt_state, m = adamw_update(params, grads, self.opt_state, self.ocfg,
                                                      lscale)
        return {"loss": loss.detach(), **m}

    def checkpoint_tree(self) -> Dict[str, Any]:
        """``{"params", "opt"}`` in the reference's layout."""
        st = self.opt_state
        return {"params": to_reference(self.params, self.cfg),
                "opt": {"mu": to_reference(st["mu"], self.cfg),
                        "nu": to_reference(st["nu"], self.cfg), "count": st["count"]}}

    def load_state(self, tree: Dict[str, Any]) -> None:
        """Take params and optimizer state from a ``checkpoint_tree()``-shaped
        tree (the reference's layout, tensors on this trainer's device)."""
        opt = tree["opt"]
        self.params = from_reference(tree["params"], self.cfg)
        self.opt_state = {"mu": from_reference(opt["mu"], self.cfg),
                          "nu": from_reference(opt["nu"], self.cfg), "count": opt["count"]}

    def restore(self) -> bool:
        """Load the latest checkpoint, if any, and continue after it."""
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            return False
        step, tree, _ = load_checkpoint(self.ckpt_dir, device=self.device)
        self.load_state(tree)
        self.step = step + 1
        return True

    def run(self, steps: int, ckpt_every: int = 50, log_every: int = 10):
        history = []
        for _ in range(steps):
            loss = float(self.train_step()["loss"])
            history.append({"step": self.step, "loss": loss})
            if self.step % log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f}", flush=True)
            if self.ckpt and self.step % ckpt_every == 0:
                self.ckpt.save(self.step, self.checkpoint_tree())
            self.step += 1
        if self.ckpt:
            self.ckpt.wait()
        return history


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
                    help="the 2 x 16 x 16 production mesh (not on one device)")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_production_mesh(multi_pod=True) if args.multi_pod else make_mesh(args.device)
    pc = param_counts(cfg)
    print(f"arch={cfg.name} params~{pc['total']/1e6:.1f}M active~{pc['active']/1e6:.1f}M "
          f"device={mesh.device}")
    tr = Trainer(cfg, mesh, seq_len=args.seq_len, global_batch=args.batch,
                 ckpt_dir=args.ckpt_dir)
    tr.restore()
    hist = tr.run(args.steps)
    print(f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
