"""The port's host samplers (repro_torch/core/speculative.py) against the
reference's (repro/core/speculative.py): the same numpy logits and keys
made from the same seeds (jax.random keys for the reference, prng keys for
the port, equal bit for bit) must give the same draft tokens, committed
tokens, accepted tree paths and accept counts, over temperature x top-k x
top-p, draft lengths 1-5 and random trees of fan-out 1-3.  The top-k,
top-p and softmax filters are numpy on both sides and must be equal bit
for bit."""
import itertools

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402

from repro.core import speculative as ref  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import speculative as port  # noqa: E402

V = 512
PARAMS = list(itertools.product([0.3, 0.8, 1.5], [0, 5, 50], [1.0, 0.9, 0.5]))
PARAM_IDS = [f"t{t}-k{k}-p{p}" for t, k, p in PARAMS]


def _keys(seed, *data):
    """(reference key, port key) of a seed with ``data`` folded in."""
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for d in data:
        jk, pk = jax.random.fold_in(jk, d), prng.fold_in(pk, d)
    return jk, pk


def _logits(rng, n):
    """Draft and target logits over a shared base, so some drafts are
    accepted and some rejected."""
    base = rng.randn(n, V).astype(np.float32) * 2.5
    q = (base + rng.randn(n, V).astype(np.float32) * 0.7).astype(np.float32)
    p = (base + rng.randn(n, V).astype(np.float32) * 0.7).astype(np.float32)
    return p, q


@pytest.mark.parametrize("top_k", [0, 1, 5, 50, V])
@pytest.mark.parametrize("top_p", [1.0, 0.95, 0.9, 0.5, 1e-3])
def test_filters_bitwise(top_k, top_p):
    rng = np.random.RandomState(top_k + int(top_p * 100))
    lg = rng.randn(3, V).astype(np.float32) * 3.0
    lg[1, :7] = lg[1, 7]  # ties at the top-k threshold and in the nucleus sort
    got_k = port._top_k_filter_host(lg, top_k)
    np.testing.assert_array_equal(got_k, ref._top_k_filter_host(lg, top_k))
    scaled = got_k / np.float32(0.8)
    np.testing.assert_array_equal(port._top_p_filter_host(scaled, top_p),
                                  ref._top_p_filter_host(scaled, top_p))
    np.testing.assert_array_equal(port._softmax_host(scaled), ref._softmax_host(scaled))


@pytest.mark.parametrize("temperature,top_k,top_p", PARAMS, ids=PARAM_IDS)
def test_sample_token_host(temperature, top_k, top_p):
    rng = np.random.RandomState(int(temperature * 10) + top_k)
    lg = rng.randn(40, V).astype(np.float32) * 2.0
    for i, row in enumerate(lg):
        jk, pk = _keys(i, 0, 3, i)
        want = ref.sample_token_host(jk, row, temperature, top_k, top_p)
        assert port.sample_token_host(pk, row, temperature, top_k, top_p) == want


@pytest.mark.parametrize("temperature,top_k,top_p", PARAMS, ids=PARAM_IDS)
def test_speculative_sample_host(temperature, top_k, top_p):
    """dl 1-5, four rounds each, drafts drawn by sample_token_host from the
    draft rows (as the engine draws them), decided by the accept key."""
    rng = np.random.RandomState(7 + top_k)
    n_acc_seen = set()
    for dl in range(1, 6):
        for rnd in range(4):
            p, q = _logits(rng, dl + 1)
            drafts = []
            for j in range(dl):
                jk, pk = _keys(dl, 0, rnd, j)
                d = ref.sample_token_host(jk, q[j], temperature, top_k, top_p)
                assert port.sample_token_host(pk, q[j], temperature, top_k, top_p) == d
                drafts.append(d)
            jk, pk = _keys(dl, 1, rnd)
            want = ref.speculative_sample_host(jk, drafts, p, q, dl, temperature, top_k, top_p)
            got = port.speculative_sample_host(pk, drafts, p, q, dl, temperature, top_k, top_p)
            assert got == want
            n_acc_seen.add(got[1])
    assert len(n_acc_seen) > 1  # both accepting and rejecting rounds ran


def _random_tree(rng, max_fanout, n_max=12):
    """Parent node indices (-1: the root) of BFS-ordered nodes whose slots
    fan out to 1 to ``max_fanout`` children, at most ``n_max`` nodes."""
    parents, frontier = [], [0]
    while frontier and len(parents) < n_max:
        nxt = []
        for slot in frontier:
            for _ in range(rng.randint(1, max_fanout + 1)):
                if len(parents) >= n_max:
                    break
                parents.append(slot - 1)
                nxt.append(len(parents))
        frontier = nxt if rng.rand() < 0.8 else []
    return parents


@pytest.mark.parametrize("temperature,top_k,top_p", PARAMS, ids=PARAM_IDS)
@pytest.mark.parametrize("max_fanout", [1, 2, 3])
def test_speculative_tree_sample_host(temperature, top_k, top_p, max_fanout):
    """Random trees whose children are drawn i.i.d. from the draft rows of
    their parents (the q window holds only the branch points' rows, zeros
    elsewhere, as the engine builds it); path, committed tokens and
    n_acc equal."""
    rng = np.random.RandomState(100 * max_fanout + top_k)
    for trial in range(6):
        parents = _random_tree(rng, max_fanout)
        w = len(parents) + 1
        p, q_rows = _logits(rng, w)
        q = np.zeros_like(q_rows)
        nodes = []
        draws = 0
        for i, par in enumerate(parents):
            slot = par + 1
            q[slot] = q_rows[slot]
            jk, pk = _keys(trial, 0, 0, draws)
            t = ref.sample_token_host(jk, q[slot], temperature, top_k, top_p)
            assert port.sample_token_host(pk, q[slot], temperature, top_k, top_p) == t
            nodes.append(t)
            draws += 1
        jk, pk = _keys(trial, 1, 0)
        want = ref.speculative_tree_sample_host(jk, nodes, parents, p, q, temperature, top_k,
                                                top_p)
        got = port.speculative_tree_sample_host(pk, nodes, parents, p, q, temperature, top_k,
                                                top_p)
        assert got == want


def test_tree_rule_at_fanout_one_is_the_chain_rule():
    """A fan-out-1 tree is a chain: the accepted path is a prefix of it,
    and the committed tokens are that prefix plus one residual or bonus
    token."""
    rng = np.random.RandomState(3)
    for trial in range(10):
        dl = 4
        p, q = _logits(rng, dl + 1)
        drafts = [int(np.argmax(q[j])) for j in range(dl)]
        parents = [-1] + list(range(dl - 1))
        _, pk = _keys(trial, 1, 0)
        new, path, n_acc = port.speculative_tree_sample_host(pk, drafts, parents, p, q, 0.8)
        assert path == list(range(n_acc))
        assert new[:n_acc] == drafts[:n_acc] and len(new) == n_acc + 1
