"""The training path on the card against the CPU, at smoke size, no JAX:
``loss_fn`` and its gradients for every configuration of the registry,
remat against no remat, and three ``Trainer`` steps (loss, grad_norm,
parameters).  Weights are made on the CPU from a seed and copied.

Tolerances (float32 on both devices, TF32 off): loss atol 1e-5; each
gradient leaf within 1e-4 of its own max |g| (the card sums in other
orders; the SSM's float32 SSD is the widest); grad_norm rtol 1e-5;
parameters after three steps atol 1e-5 (Adam can move a parameter whose
gradient is near zero by up to 2 * lr_t on a last-bit difference; lr_t
<= 1e-4 here).  Remat must change no bit on the card either.

Run on the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_train_cuda.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.models.common import Family

pytestmark = pytest.mark.cuda
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
NORM_RTOL = 1e-5
PARAM_ATOL = 1e-5


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _extras(cfg, batch, device):
    g = torch.Generator().manual_seed(1)
    if cfg.family is Family.VLM:
        return {"vision_embeds": torch.randn((batch, cfg.n_vision_tokens, cfg.d_model),
                                             generator=g).to(device)}
    if cfg.family is Family.AUDIO:
        return {"frames": torch.randn((batch, cfg.n_audio_frames, cfg.d_model),
                                      generator=g).to(device)}
    return {}


def _grads(params, cfg, toks, kw):
    params = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = lm.loss_fn(params, cfg, toks, **kw)
    return loss.detach(), tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_and_grads_card_vs_cpu(cuda, arch):
    cfg = configs.get_smoke(arch)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=torch.Generator().manual_seed(2))
    loss, grads = _grads(params, cfg, toks, _extras(cfg, 2, "cpu"))
    on_card = tree_map(lambda t: t.to(cuda), params)
    kw = _extras(cfg, 2, cuda)
    closs, cgrads = _grads(on_card, cfg, toks.to(cuda), kw)
    assert abs(float(closs) - float(loss)) <= LOSS_ATOL
    for g, c in zip(tree_leaves(grads), tree_leaves(cgrads)):
        w = g.numpy()
        np.testing.assert_allclose(c.cpu().numpy(), w, atol=GRAD_RTOL * max(np.abs(w).max(), 1e-30))
    nloss, ngrads = _grads(on_card, dataclasses.replace(cfg, remat=False), toks.to(cuda), kw)
    assert torch.equal(nloss, closs)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ngrads), tree_leaves(cgrads)))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b", "qwen3-8b", "whisper-large-v3"])
def test_trainer_three_steps_card_vs_cpu(cuda, arch):
    cfg = configs.get_smoke(arch)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    cpu = train.Trainer(cfg, seq_len=16, global_batch=4, params=params, device="cpu")
    card = train.Trainer(cfg, seq_len=16, global_batch=4,
                         params=tree_map(lambda t: t.to(cuda), params))
    assert card.device.type == "cuda"
    for _ in range(3):
        a, b = cpu.train_step(), card.train_step()
        cpu.step += 1
        card.step += 1
        assert abs(float(a["loss"]) - float(b["loss"])) <= LOSS_ATOL
        assert float(b["grad_norm"]) == pytest.approx(float(a["grad_norm"]), rel=NORM_RTOL)
    for x, y in zip(tree_leaves(cpu.params), tree_leaves(card.params)):
        np.testing.assert_allclose(y.cpu().numpy(), x.numpy(), atol=PARAM_ATOL)
