"""Whole runs of the harness on the CPU at smoke size (no chip): a cell,
mix, metric and family added as new files only; the control and planted
faults coming out as not correct."""
from __future__ import annotations

import time

import pytest

import bench_testkit as kit
from benchkit import cli

SEED = 2**31 + 17


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    root = kit.scratch_checkout(tmp_path_factory.mktemp("checkout"))
    return cli.Manifest(root, root / "bench")


def _run(man, cell, trace=False, control=False):
    return cli.run_cell(man, man.cell(cell), SEED, 0.6, trace, "cpu", time.perf_counter(),
                        control=control)


def _passes(res, name):
    c = res["checks"][name]
    return c["value"] is not None and c["value"] <= c["limit"]


def test_new_cell_mix_and_metric_from_files(man):
    res = _run(man, "q.open", control=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "tokens_per_s"}
    assert list(res)[-1] == "checks"
    # the control (W4A4 target, float8 draft) reads above the limits the program stays under
    r = res["readings"]
    assert r["max_logit_gap"] <= res["checks"]["max_logit_gap"]["limit"] < r["control_gap"]
    assert r["draft_proposals"] > 0
    for name in ("draft_mean_logit_gap", "draft_lloyd_gain"):
        assert _passes(res, name)
    assert r["draft_max_logit_gap"] < r["draft_control_max_logit_gap"]
    assert (r["draft_mean_logit_gap"] <= res["checks"]["draft_mean_logit_gap"]["limit"]
            < r["draft_control_mean_logit_gap"])
    traced = _run(man, "q.open", trace=True)
    assert traced["correct"]
    assert traced["metrics"]["served_per_request"]["value"] > 0
    assert {"accept_rate", "round_ms", "rows_per_round", "itl_p95_ms"} <= set(traced["metrics"])
    assert traced["device"]["window_s"] > 0 and "breakdown" in traced


def test_new_family_and_the_bf16_pair(man):
    res = _run(man, "s.open")
    assert res["correct"] and res["readings"]["draft_proposals"] > 0
    assert set(res["checks"]) == {"max_logit_gap", "draft_max_logit_gap"}
    assert _run(man, "n.open")["correct"]


def test_altered_token_is_not_correct(man, monkeypatch):
    from repro_torch.serving import engine as E
    accept = E.speculative_accept_greedy_host

    def altered(drafts, p_logits, dl):
        new, n_acc = accept(drafts, p_logits, dl)
        return [(t + 1) % p_logits.shape[-1] for t in new], n_acc
    monkeypatch.setattr(E, "speculative_accept_greedy_host", altered)
    res = _run(man, "q.open")
    assert not res["correct"] and not _passes(res, "max_logit_gap")


def test_state_left_unchanged_is_not_correct(man, monkeypatch):
    """A step that never writes its KV into the pools."""
    from repro_torch.models import layers as L
    upd = L.paged_attention_update

    def no_write(q, k_new, v_new, pc):
        saved = pc.k.clone(), pc.v.clone()
        out = upd(q, k_new, v_new, pc)
        pc.k.copy_(saved[0])
        pc.v.copy_(saved[1])
        return out
    monkeypatch.setattr(L, "paged_attention_update", no_write)
    res = _run(man, "q.open")
    assert not res["correct"]


def test_draft_kernel_that_skips_its_work_is_not_correct(man, monkeypatch):
    """K3 returning zeros changes no served token (the target verifies
    every one); the draft's proposals give it away."""
    import torch
    from repro_torch.kernels import ops

    def zeros(x, cb, idx):
        return torch.zeros((x.shape[0], idx.shape[0] * idx.shape[2]), dtype=torch.float32)
    monkeypatch.setattr(ops, "bvq_matmul", zeros)
    res = _run(man, "q.open")
    assert _passes(res, "max_logit_gap")
    assert not res["correct"] and not _passes(res, "draft_mean_logit_gap")
