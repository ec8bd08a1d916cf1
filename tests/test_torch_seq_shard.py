"""Sequence parallelism in the port, against the JAX reference.

* the flash kernel's plain versions at a query offset: a shard of the
  queries at ``q_offset`` = o against the whole sequence's keys equals
  rows [o, o + n) of the reference's ``flash_attention_ref`` over the
  whole sequence, and its gradients (dQ of those rows, dK and dV summed
  over the shards) equal ``jax.vjp`` of the reference's whole function;
  ``q_offset=0`` is the plain version as it was, bit for bit;
* the work formulas at an offset against a brute-force count of the mask;
* a shard's first position from the mesh coordinate and the placements;
* the decode's chunk form and its combine against the reference's
  ``decode_attend_chunk`` / ``combine_decode``;
* the split decode (and the sequence-parallel prefill) on 4 gloo ranks
  against the unsharded serving path, with a planted fault, and the cost
  analyser's count of its all-reduces and their link bytes;
* a dry run with a sharded sequence: its per-device FLOPs at most the
  dense work over the ranks plus the last shard's attention.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as JA
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref, work
from repro_torch.launch import shard_check
from repro_torch.models import attention as TA

#: (B, S, H, K, D, causal, window, softcap) at the shard size n = S / 4
CASES = {
    "causal_gqa": (2, 48, 4, 2, 16, True, 0, 0.0),
    "window_mqa": (2, 48, 4, 1, 16, True, 20, 0.0),
    "softcap": (1, 48, 4, 2, 16, True, 0, 30.0),
    "noncausal": (2, 48, 4, 4, 16, False, 0, 0.0),
}
SHARDS = 4
TOL = 1e-5


def _inputs(case, seed=0):
    B, S, H, K, D = CASES[case][:5]
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                          (B, S, H, D))]


def _opts(case):
    causal, window, softcap = CASES[case][5:]
    return dict(causal=causal, window=window, softcap=softcap)


@pytest.mark.parametrize("case", list(CASES))
def test_offset_rows_match_the_reference(case):
    """Each quarter of the queries at its offset: the reference's rows."""
    q, k, v, _ = _inputs(case)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **_opts(case)))
    n = q.shape[1] // SHARDS
    for o in range(0, q.shape[1], n):
        got = kfa.flash_attention(torch.from_numpy(q[:, o:o + n]),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  q_offset=o, **_opts(case))
        np.testing.assert_allclose(got.numpy(), want[:, o:o + n], rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_offset_gradients_match_the_reference(case):
    """Through ``ops.flash_attention``'s autograd: dQ of each shard's rows,
    and dK, dV summed over the shards, equal ``jax.vjp`` of the
    reference's whole function."""
    q, k, v, do = _inputs(case, seed=1)
    opts = _opts(case)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c,
                                                              **opts),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wq, wk, wv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    n = q.shape[1] // SHARDS
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for o in range(0, q.shape[1], n):
        qs = torch.from_numpy(q[:, o:o + n]).requires_grad_()
        ks = torch.from_numpy(k).requires_grad_()
        vs = torch.from_numpy(v).requires_grad_()
        out = ops.flash_attention(qs, ks, vs, q_offset=o, **opts)
        out.backward(torch.from_numpy(do[:, o:o + n]))
        np.testing.assert_allclose(qs.grad.numpy(), wq[:, o:o + n], rtol=0,
                                   atol=TOL)
        dk += ks.grad.numpy()
        dv += vs.grad.numpy()
    np.testing.assert_allclose(dk, wk, rtol=0, atol=TOL)
    np.testing.assert_allclose(dv, wv, rtol=0, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_offset_zero_is_the_plain_version_bit_for_bit(case):
    """``q_offset=0`` given or left out: the same bits, forward (with its
    lse) and backward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=2))
    opts = _opts(case)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **opts)
    o0, lse0 = ref.flash_attention_ref(q, k, v, return_lse=True, q_offset=0,
                                       **opts)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    g = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **opts)
    g0 = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, q_offset=0, **opts)
    assert all(torch.equal(a, b) for a, b in zip(g, g0))
    assert torch.equal(ops.flash_attention(q, k, v, **opts),
                       ops.flash_attention(q, k, v, q_offset=0, **opts))


@pytest.mark.parametrize("Sq,Skv,causal,window,offset", [
    (12, 48, True, 0, 36), (12, 48, True, 20, 24), (12, 48, False, 0, 12),
    (7, 30, True, 5, 23), (16, 64, True, 0, 0), (5, 9, True, 3, 4)])
def test_offset_work_counts_the_mask(Sq, Skv, causal, window, offset):
    """``visible_pairs`` at an offset: the pairs the plain version's mask
    lets through; the forward and backward formulas scale with them."""
    qp = torch.arange(offset, offset + Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    pairs = int(mask.sum())
    assert work.visible_pairs(Sq, Skv, causal, window, offset) == pairs
    B, H, K, D = 2, 4, 2, 16
    assert work.flash_work(B, Sq, Skv, H, K, D, causal, window, 2,
                           q_offset=offset)[0] == 2 * B * H * pairs * 2 * D
    assert work.flash_bwd_work(B, Sq, Skv, H, K, D, causal, window, 2,
                               q_offset=offset)[0] == 10 * D * B * H * pairs


@pytest.mark.parametrize("dims,offsets", [
    ((1, 1), [0, 4, 8, 12]), ((0, 1), [0, 8, 0, 8]), ((1, 0), [0, 0, 8, 8])])
def test_shard_offset_from_the_mesh(dims, offsets):
    """``seq_offset`` of a length-16 dim 1 on each rank of a fake (2, 2)
    group: a dim split by both mesh dims in mesh-dim order (rank 2·i + j
    at coordinate (i, j))."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch._dtensor import seq_offset
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_local_mesh
    pl = [Shard(d) if d == 1 else Replicate() for d in dims]
    got = []
    for rank in range(4):
        with fake_world(4, rank=rank):
            got.append(seq_offset(make_local_mesh((2, 2)), pl, 16))
    assert got == offsets


def test_chunk_form_and_combine_match_the_reference():
    """``decode_attend_chunk`` on three chunks of a cache and their
    ``combine_decode``: the reference's on the same chunks, and one
    chunk's ``decode_attend`` over the whole cache."""
    rng = np.random.default_rng(3)
    B, S, H, K, D = 2, 30, 4, 2, 16
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    k, v = (rng.normal(0, 1, (B, S, K, D)).astype(np.float32)
            for _ in range(2))
    pos = np.array([25, 11], np.int32)
    kv_pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    kw = dict(scale=0.25, softcap=20.0, window=16)
    parts, jparts = [], []
    for a, b in ((0, 8), (8, 20), (20, 30)):
        parts.append(TA.decode_attend_chunk(
            torch.from_numpy(q), torch.from_numpy(k[:, a:b]),
            torch.from_numpy(v[:, a:b]), torch.from_numpy(pos),
            torch.from_numpy(kv_pos[:, a:b]), **kw))
        jparts.append(JA.decode_attend_chunk(
            jnp.asarray(q), jnp.asarray(k[:, a:b]), jnp.asarray(v[:, a:b]),
            jnp.asarray(pos), jnp.asarray(kv_pos[:, a:b]), **kw))
        for t, j in zip(parts[-1], jparts[-1]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                       atol=TOL)
    got = TA.combine_decode(parts).numpy()
    np.testing.assert_allclose(got, np.asarray(JA.combine_decode(jparts)),
                               rtol=0, atol=TOL)
    whole = TA.decode_attend(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(pos),
                             torch.from_numpy(kv_pos), **kw)
    np.testing.assert_allclose(got, whole.numpy(), rtol=0, atol=TOL)


def test_split_decode_on_four_gloo_ranks(tmp_path):
    """On a (2, 2) mesh of 4 gloo ranks, for global attention, the local
    ring buffer and MLA's latent, in both cache layouts: the
    sequence-parallel prefill and 3 decode steps over a cache sharded on
    its slots (the chunks combined across the ranks) within
    ``shard_check.LIMIT`` of the unsharded path, every rank; the chunks
    attended alone, past it."""
    recs = shard_check.run_decode_ranks(
        faults=(False, True), timeout_s=240, work=str(tmp_path))
    normal = [r for r in recs if not r["fault"]]
    fault = [r for r in recs if r["fault"]]
    assert len(normal) == 4 * len(shard_check.DECODE_ARCHS) * len(
        shard_check.DECODE_LAYOUTS)
    for r in normal:
        assert shard_check.decode_ok(r), r
        assert r["prefill_seq_axes"] == ["model"]
        assert r["chunk_dims"] == ([0, 1] if r["layout"] == "slots_data_model"
                                   else [1])
    assert not any(shard_check.decode_ok(r) for r in fault), fault
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_sequence_sharded_dry_run_divides_the_dense_work():
    """A reduced granite-8b train step (batch 2 x 64) on a fake (2, 2)
    group, the batch over "data" and the sequence over "model": the last
    rank's FLOPs at most the step's dense FLOPs on one rank over 4, plus
    the attention of the last shard of the sequence (forward and
    backward, every layer).  AdamW's kernel, charged its elementwise
    operations, is left out on both sides: the small leaves it updates
    are replicated, whole on every rank, and its operations are no part
    of the dense work."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import fake_world, measure
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import ShapeSpec
    cfg = get_config("granite-8b").reduced()
    B, S = 2, 64
    shape = ShapeSpec("seq", S, B, "train")
    with fake_world(1):
        whole = measure(cfg, shape, make_local_mesh((1, 1)))["cost"]
    with fake_world(4, rank=-1):
        last = measure(cfg, shape, make_local_mesh((2, 2)))["cost"]
    attn = sum(whole["kernels"][n]["flops"] for n in
               ("flash_attention", "flash_attention_bwd"))
    adamw = lambda cost: cost["kernels"]["adamw"]["flops"]  # noqa: E731
    dense = whole["flops"] - attn - adamw(whole)
    n = S // 2
    args = (B // 2, n, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd, True,
            cfg.window, 2)
    shard_attn = cfg.n_layers * (
        work.flash_work(*args, q_offset=S - n)[0]
        + work.flash_bwd_work(*args, q_offset=S - n)[0])
    assert last["kernels"]["flash_attention"]["launches"] == cfg.n_layers
    assert last["flops"] - adamw(last) <= dense / 4 + shard_attn, (
        last["flops"], dense, shard_attn)
    # the last shard's attention is what the rank was charged
    charged = sum(last["kernels"][n]["flops"] for n in
                  ("flash_attention", "flash_attention_bwd"))
    assert charged == shard_attn


def test_split_decode_collectives_in_the_analyser():
    """A decode step of reduced granite-3-8b (batch 2) on a fake (2, 2)
    group over a cache whose slots both mesh dims shard: the cost
    analyser counts, a layer and a mesh dim, one all-reduce of the max
    (B, H) and one of the rescaled sums (B, H, hd + 1), each with its
    ring link bytes (2 (n - 1) / n of its float32 result, n = 2)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.act_sharding import activation_sharding
    from repro_torch.distributed.auto_shard import Spec, shard_tree
    from repro_torch.distributed.cost import counting
    from repro_torch.launch import steps as S
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import LM
    cfg = get_config("granite-3-8b").reduced()
    model, B = LM(cfg), 2
    params = S.cast_params(model.init(0, "cpu"), cfg.compute_dtype)
    cache = model.init_cache(B, 64, "cpu")
    with fake_world(4):
        mesh = make_local_mesh((2, 2))
        sp = shard_tree(params, mesh, S.state_specs(
            cfg, mesh, {"params": params}, min_elems=0)["params"])
        sc = shard_tree(cache, mesh, shard_check.layout_specs(
            cache, shard_check.DECODE_LAYOUTS["slots_data_model"]))
        tok = shard_tree(torch.zeros(B, dtype=torch.long), mesh,
                         Spec(("data",)))
        with implicit_replication(), \
                activation_sharding(Spec(("data",), None)), \
                counting() as c:
            model.decode_step(sp, sc, tok)
    res = c.result()
    per = 2 * cfg.n_layers          # a layer, a mesh dim
    assert res["collective_counts"]["all-reduce"] == per * 2
    want = per * 4 * (B * cfg.n_heads + B * cfg.n_heads * (cfg.hd + 1))
    assert res["collective_bytes"]["all-reduce"] == want
