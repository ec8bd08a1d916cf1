"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference's ``repro.models.moe``, on the CPU.

Both sides get the same float32 weights (drawn by the reference's
``init_moe`` and carried over as numpy) and the same inputs (numpy from
a seed): the router's weights, expert indices and load-balance loss;
``moe_forward``'s capacity dispatch with and without drops (the
overloaded case of the reference's ``tests/test_moe.py``), with and
without shared experts; the single-token dense combine; the capacity
formula; the gradients of ``moe_forward`` against ``jax.grad``; and the
reference's layer groups of an MoE stack (its dense first layer a group
of its own) carried across by ``convert``.

Tolerances, float32: 1e-5 absolute for one layer's outputs (O(1) values,
the same operations in other orders); indices equal.  Gradients within
1e-4 of each leaf's largest magnitude, as ``tests/test_torch_train.py``
holds the LM's.  Routing must not depend on a tie: every case first
checks that its k-th and (k+1)-th probabilities are apart
(``_no_ties``), since ``jax.lax.top_k`` and ``torch.topk`` may order
equal values differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.models import moe as TMoE
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import build_specs, tensors, tree_map

ATOL_LAYER = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="granite-moe-3b-a800m", **over):
    base = dict(d_model=48, d_ff_expert=32)
    base.update(over)
    return (jget_config(arch).reduced(**base),
            get_config(arch).reduced(**base))


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, tree))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _no_ties(p, x, cfg):
    """The k-th and (k+1)-th router probabilities of every token are
    apart by more than float32 rounding, so top-k has one answer."""
    logits = np.asarray(x) @ np.asarray(p["router"]["w"])
    z = np.exp(logits - logits.max(-1, keepdims=True))
    probs = np.sort(z / z.sum(-1, keepdims=True), axis=-1)[..., ::-1]
    if cfg.top_k < cfg.n_experts:
        gap = probs[..., cfg.top_k - 1] - probs[..., cfg.top_k]
        assert gap.min() > 1e-5, gap.min()


# arch, overrides, (B, S): granite-moe has no shared experts,
# deepseek-v2-lite has one (reduced); "overloaded" is the reference test's
# capacity factor of 0.3, where most pairs are dropped
FORWARD_CASES = {
    "granite_default": ("granite-moe-3b-a800m", {}, (2, 24)),
    "granite_no_drop": ("granite-moe-3b-a800m", {"capacity_factor": 16.0},
                        (2, 12)),
    "granite_overloaded": ("granite-moe-3b-a800m",
                           {"capacity_factor": 0.3}, (1, 64)),
    "deepseek_default": ("deepseek-v2-lite-16b", {}, (2, 24)),
    "deepseek_overloaded": ("deepseek-v2-lite-16b",
                            {"capacity_factor": 0.3, "top_k": 2}, (2, 40)),
}


def _case(name, seed=0):
    arch, over, shape = FORWARD_CASES[name]
    jc, tc = _cfgs(arch, **over)
    p = JMoE.init_moe(jax.random.key(seed), jc)
    x = _x(shape + (jc.d_model,), seed + 1)
    _no_ties(p, x, jc)
    return jc, tc, p, x


def test_router_matches_reference():
    jc, tc, p, x = _case("granite_default")
    w, idx, aux = TMoE._router(_t(p), torch.from_numpy(x), tc)
    jw, jidx, jaux = JMoE._router(p, jnp.asarray(x), jc)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw, ATOL_LAYER)
    _close(aux, jaux, ATOL_LAYER)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(aux) >= 1.0 - 1e-5


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_moe_forward_matches_reference(name):
    """The dispatch path (S > 1): the layer's output and aux loss; the
    overloaded cases must really drop pairs, the no-drop case none."""
    jc, tc, p, x = _case(name)
    y, aux = TMoE.moe_forward(_t(p), torch.from_numpy(x), tc)
    jy, jaux = JMoE.moe_forward(p, jnp.asarray(x), jc)
    _close(y, jy, ATOL_LAYER)
    _close(aux, jaux, ATOL_LAYER)
    _, idx, _ = TMoE._router(_t(p), torch.from_numpy(x), tc)
    C = TMoE.capacity(tc, x.shape[1])
    dropped = int((TMoE.slots(idx, tc.n_experts, C)
                   == tc.n_experts * C).sum())
    if "overloaded" in name:
        assert dropped > 0
    if "no_drop" in name:
        assert dropped == 0


def test_slots_are_unique_and_within_capacity():
    """Kept pairs take distinct rows, at most C an expert a sequence, in
    s-major k-minor order (an expert's first pairs are kept first)."""
    jc, tc, p, x = _case("granite_overloaded")
    _, idx, _ = TMoE._router(_t(p), torch.from_numpy(x), tc)
    E, C = tc.n_experts, TMoE.capacity(tc, x.shape[1])
    dest = TMoE.slots(idx, E, C)
    for b in range(dest.shape[0]):
        kept = dest[b][dest[b] < E * C]
        assert len(set(kept.tolist())) == len(kept)
        flat = idx[b].reshape(-1)
        for e in range(E):
            rows = dest[b][flat == e]
            n = min(C, len(rows))
            assert rows[:n].tolist() == [e * C + i for i in range(n)]
            assert (rows[n:] == E * C).all()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_decode_matches_reference(arch):
    """S == 1: the dense masked combine over all experts (and the
    shared expert), through ``moe_forward`` as decode reaches it."""
    jc, tc = _cfgs(arch)
    p = JMoE.init_moe(jax.random.key(3), jc)
    x = _x((3, 1, jc.d_model), 4)
    _no_ties(p, x, jc)
    y, aux = TMoE.moe_forward(_t(p), torch.from_numpy(x), tc)
    jy, jaux = JMoE.moe_forward(p, jnp.asarray(x), jc)
    _close(y, jy, ATOL_LAYER)
    _close(aux, jaux, ATOL_LAYER)


def test_capacity_matches_reference_and_its_bounds():
    for E, k, cf in ((8, 2, 1.0), (40, 8, 1.25), (64, 6, 1.25), (4, 2, 0.3)):
        jc, tc = _cfgs(n_experts=E, top_k=k, capacity_factor=cf)
        for S in (1, 4, 8, 9, 64, 3000, 3064):
            c = TMoE.capacity(tc, S)
            assert c == JMoE.capacity(jc, S)
            assert 8 <= c <= max(S, 8)


def test_moe_gradients_match_jax():
    """d/d(params, x) of sum(y²) + aux, through the dispatch with drops
    (dropped pairs get no gradient through the experts)."""
    jc, tc, p, x = _case("deepseek_overloaded")

    def jloss(pp, xx):
        y, aux = JMoE.moe_forward(pp, xx, jc)
        return jnp.sum(y ** 2) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = tree_map(lambda a: a.requires_grad_(), _t(p))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TMoE.moe_forward(tp, tx, tc)
    leaves = list(tensors(tp)) + [tx]
    grads = torch.autograd.grad((y ** 2).sum() + aux, leaves)
    want = [np.asarray(a) for a in tensors(_t(jgp))] + [np.asarray(jgx)]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_RTOL * max(np.abs(w).max(), 1e-12), (err, g.shape)


def test_moe_groups_carry_across_layer_by_layer():
    """Reduced deepseek-v2-lite at depth 3: the reference groups its
    stack as (attn, dense_mlp) x 1 then (attn, moe) x 2; each of the
    port's layers is that group's slice, the dense layer's FFN of
    ``dense_d_ff`` and the MoE layers' experts in their own layouts."""
    jc, tc = _cfgs("deepseek-v2-lite-16b", n_layers=3)
    tree = jax.tree.map(np.asarray, JM.LM(jc).init(jax.random.key(5)))
    assert [g.repeats for g in JM.build_groups(jc)] == [1, 2]
    params = params_from_reference(tc, tree)
    assert [(s.kind, s.ffn) for s in build_specs(tc)] == \
        [("attn", "dense_mlp"), ("attn", "moe"), ("attn", "moe")]
    want = [(tree["groups"][0]["0"], 0), (tree["groups"][1]["0"], 0),
            (tree["groups"][1]["0"], 1)]
    assert len(params["layers"]) == len(want)
    for got, (group, r) in zip(params["layers"], want):
        g = jax.tree.map(lambda a, r=r: a[r], group)
        assert set(got) == set(g)
        flat_got = list(tensors(got))
        flat_want = list(tensors(_t(g)))
        assert len(flat_got) == len(flat_want)
        for a, b in zip(flat_got, flat_want):
            assert a.shape == b.shape and torch.equal(a, b)
    assert params["layers"][0]["ffn"]["gate"]["w"].shape == \
        (tc.d_model, tc.dense_d_ff)
    assert params["layers"][1]["ffn"]["gate"].shape == \
        (tc.n_experts, tc.d_model, tc.d_ff_expert)
    # the port's own init makes the same structure and shapes
    mine = LM(tc).init(0, "cpu")
    for a, b in zip(mine["layers"], params["layers"]):
        assert tree_map(lambda t: tuple(t.shape), a) == \
            tree_map(lambda t: tuple(t.shape), b)
