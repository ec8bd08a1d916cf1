"""The port's error-feedback int8 all-reduce against the JAX reference.

``repro_torch.distributed.compress`` and the plain version of its kernel
(``kernels/ref.py int8_quant_ref``) are held against the reference's
``distributed/compress.py`` and ``kernels/ref.py`` on the same numpy-made
inputs; the CUDA kernel runs only on the card, and its test skips here.

Tolerances, and why:
- quantization, ``dequantize`` and one-rank ``compressed_psum`` (and its
  tree) against the *eager* reference: bit for bit, codes and scales,
  NaN and inf blocks included.  Both compute in float32 with IEEE division
  and round half to even.
- against the Pallas kernel in interpret mode, and inside ``shard_map``:
  codes equal, scales to rtol 1e-6 (the reference's own tolerance,
  ``tests/test_kernels.py``).  Jitted, XLA divides by 127 as a multiply by
  the reciprocal, which leaves some scales one ulp lower than eager.
- the four-rank run against the reference's four-device ``shard_map``
  run: each rank's new error bit for bit against the eager reference
  pieces; the all-reduced mean within 1e-6 of its largest magnitude, plus
  one quantization step (scale / 4) in a block where a jitted scale
  differs from the eager one (one code there may round the other way).
"""
import datetime
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro.distributed import compress as jc
from repro.kernels import ref as jref
from repro.kernels.int8_quant import int8_quantize as pallas_quant
from repro_torch.distributed import compress as tc
from repro_torch.kernels import int8_quant as kq8
from repro_torch.kernels import ops, ref

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
#: every spawned rank and reference process finishes within this, or the
#: test kills it and fails
SPAWN_TIMEOUT_S = 150


def _special(name):
    """Inputs whose quantization has a corner: short, ragged, exact
    halves (round half to even), all-zero blocks, scales clamped at
    1e-12, huge values, NaN and ±inf blocks."""
    rng = np.random.default_rng(7)
    if name == "short":
        return rng.normal(0, 2, 100)
    if name == "one_block":
        return rng.normal(0, 2, 256)
    if name == "ragged":
        return rng.normal(0, 2, 256 * 5 + 17)
    if name == "matrix":
        return rng.normal(0, 1e-3, (37, 50))
    if name == "halves":
        return np.arange(256) - 127.5
    if name == "halves_scaled":
        return np.concatenate([(np.arange(256) - 127.5) * 0.75,
                               (np.arange(256) - 127.5) * 2.0 ** -20])
    if name == "zeros":
        return np.zeros(600)
    if name == "tiny":
        return rng.normal(0, 1e-14, 700)
    if name == "huge":
        return rng.normal(0, 1e36, 300)
    if name == "nan_inf":
        x = rng.normal(0, 1, 256 * 4)
        x[3], x[300], x[600], x[700] = np.nan, np.inf, -np.inf, np.nan
        return x
    if name == "empty":
        return np.zeros(0)
    raise KeyError(name)


SPECIAL = ("short", "one_block", "ragged", "matrix", "halves",
           "halves_scaled", "zeros", "tiny", "huge", "nan_inf", "empty")


def _bits(a) -> np.ndarray:
    """Float32 bit patterns, every NaN as one pattern."""
    a = np.array(a, np.float32)
    a[np.isnan(a)] = np.nan
    return a.view(np.uint32)


def _assert_same_quant(tq, ts, jq, js):
    np.testing.assert_array_equal(np.asarray(tq), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


def _both_plain(x):
    """The port's three CPU entry points of quantization, each as numpy."""
    t = torch.from_numpy(np.asarray(x, np.float32))
    return [tuple(a.numpy() for a in fn(t)) for fn in
            (ref.int8_quant_ref, tc.quantize, kq8.int8_quantize)]


@pytest.mark.parametrize("name", SPECIAL)
def test_plain_quantization_matches_eager_reference(name):
    x = np.asarray(_special(name), np.float32)
    jq, js = jc.quantize(jnp.asarray(x))
    rq, rs = jref.int8_quant_ref(jnp.asarray(x))
    _assert_same_quant(rq, rs, jq, js)
    for tq, ts in _both_plain(x):
        _assert_same_quant(tq, ts, jq, js)
    if name == "nan_inf":
        # a NaN block: scale NaN, also beside a -inf (block 2); an inf
        # block: scale inf; codes all 0
        assert np.isnan(js[0]) and np.isinf(js[1]) and np.isnan(js[2])
        assert np.isfinite(js[3]) and not np.asarray(jq)[:3].any()


@given(st.integers(1, 3000), st.integers(0, 2 ** 31 - 1),
       st.sampled_from([1e-6, 1.0, 1e4]))
@settings(max_examples=25, deadline=None)
def test_plain_quantization_matches_eager_reference_random(n, seed, sd):
    x = np.random.default_rng(seed).normal(0, sd, n).astype(np.float32)
    jq, js = jc.quantize(jnp.asarray(x))
    for tq, ts in _both_plain(x):
        _assert_same_quant(tq, ts, jq, js)


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 256 * 300 + 5])
def test_plain_quantization_matches_pallas_interpret(n):
    x = np.random.default_rng(n).normal(0, 2, n).astype(np.float32)
    pq, ps = pallas_quant(jnp.asarray(x), interpret=True)
    tq, ts = ref.int8_quant_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(pq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), rtol=1e-6)


@pytest.mark.parametrize("shape", [(100,), (37, 50), (4, 256), (3, 5, 7)])
def test_dequantize_matches_reference(shape):
    x = np.random.default_rng(3).normal(0, 4, shape).astype(np.float32)
    jq, js = jc.quantize(jnp.asarray(x))
    want = jc.dequantize(jq, js, shape)
    got = tc.dequantize(torch.from_numpy(np.array(jq)),
                        torch.from_numpy(np.array(js)), shape)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_wrapper_raises_on_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        kq8.int8_quantize(torch.zeros(300, device="meta"))


def test_compressed_psum_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tc.compressed_psum(torch.zeros(10), torch.zeros(10))


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group on a file store, torn down after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _vmap_ref(fn):
    """The reference's named-axis function, run eagerly over an axis of
    one rank: ``vmap`` dispatches op by op, so its scales are the eager
    ones (``jit`` would multiply by 1/127)."""
    return jax.vmap(fn, axis_name="d")


@pytest.mark.parametrize("shape", [(100,), (37, 50), (1024,)])
def test_one_rank_compressed_psum_matches_reference(one_rank, shape):
    """Three steps carrying the error, bit for bit."""
    rng = np.random.default_rng(11)
    f = _vmap_ref(lambda g, e: jc.compressed_psum(g, e, "d"))
    je = jnp.zeros((1,) + shape, jnp.float32)
    te = torch.zeros(shape)
    for _ in range(3):
        g = rng.normal(0, 1, shape).astype(np.float32)
        jr, je = f(jnp.asarray(g)[None], je)
        tr, te = tc.compressed_psum(torch.from_numpy(g), te)
        np.testing.assert_array_equal(_bits(tr.numpy()), _bits(jr[0]))
        np.testing.assert_array_equal(_bits(te.numpy()), _bits(je[0]))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    """Leaves in key-sorted order (``jax.tree``'s), for either package."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _torch_leaf(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a, jnp.float32)))


def test_one_rank_tree_matches_reference(one_rank):
    """``compressed_psum_tree`` over a nest of dicts and lists (a ragged
    matrix, a bf16 vector, a list of two leaves): reduced in each grad's
    dtype, errors in float32, bit for bit over three steps."""
    rng = np.random.default_rng(12)
    f = _vmap_ref(lambda g, e: jc.compressed_psum_tree(g, e, "d"))
    je = te = None
    for _ in range(3):
        g = {"w": rng.normal(0, 1e-2, (37, 50)).astype(np.float32),
             "b": np.asarray(jnp.asarray(rng.normal(0, 1, 300),
                                         jnp.bfloat16)),
             "layers": [rng.normal(0, 3, (4, 256)).astype(np.float32),
                        rng.normal(0, 1, (9,)).astype(np.float32)]}
        if je is None:
            je = _map(lambda a: jnp.zeros((1,) + a.shape, jnp.float32), g)
            te = _map(lambda a: torch.zeros(a.shape), g)
        jr, je = f(_map(lambda a: jnp.asarray(a)[None], g), je)
        tr, te = tc.compressed_psum_tree(_map(_torch_leaf, g), te)
        assert tr["b"].dtype == torch.bfloat16
        assert te["b"].dtype == torch.float32
        assert isinstance(tr["layers"], list) and len(tr["layers"]) == 2
        for a, b in zip(_leaves(tr), _leaves(jr)):
            np.testing.assert_array_equal(_bits(_f32(a)), _bits(_f32(b[0])))
        for a, b in zip(_leaves(te), _leaves(je)):
            np.testing.assert_array_equal(_bits(_f32(a)), _bits(_f32(b[0])))


def test_tree_pairs_errors_by_key(one_rank):
    """An error tree whose dict lists its keys in another order pairs
    with the gradients by key, not by position."""
    g = {"a": torch.ones(300), "b": torch.full((200,), 5.0)}
    e = {"b": torch.full((200,), 0.25), "a": torch.zeros(300)}
    _, ne = tc.compressed_psum_tree(g, e)
    _, want_b = tc.compressed_psum(g["b"], e["b"])
    assert torch.equal(ne["b"], want_b)
    with pytest.raises(ValueError):
        tc.compressed_psum_tree({"l": [torch.ones(3)]},
                                {"l": [torch.ones(3), torch.ones(3)]})


def test_error_feedback_converges(one_rank):
    """The reference's drift test through the port's one-rank
    ``compressed_psum``: accumulated sent values track the accumulated
    gradients within the residual, not a bound growing with the steps."""
    rng = np.random.default_rng(2)
    true_acc = np.zeros(256)
    ef_acc = np.zeros(256)
    err = torch.zeros(256)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(0, 1, (256,)).astype(np.float32))
        sent, err = tc.compressed_psum(g, err)
        true_acc += g.numpy()
        ef_acc += sent.numpy()
    assert np.abs(true_acc - ef_acc).max() <= float(err.abs().max()) + 1e-5


# ------------------------------------------------------------ four ranks
RANKS = 4
STEPS = 3
#: (name, shape, standard deviation) of the four-rank test's leaves, in
#: the order both scripts list them: {"w", "b", "layers": [l0]}
LEAVES = (("w", (37, 50), 1e-2), ("b", (300,), 1.0), ("l0", (4, 256), 3.0))


def _rank_grads(rank, step):
    rng = np.random.default_rng(1000 * rank + step)
    return [rng.normal(0, sd, shape).astype(np.float32)
            for _, shape, sd in LEAVES]


#: one rank: argv = rank, world, store, grads.npz, out.npz; its tree is
#: {"w", "b", "layers": [leaf]} with the grads npz's leaves in that order
_RANK_SCRIPT = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.distributed import compress
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
grads_npz = np.load(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
def tree(w, b, l0):
    return {"w": w, "b": b, "layers": [l0]}
def leaves(t):
    return [t["w"], t["b"], t["layers"][0]]
errs = None
saved = {}
for step in range(grads_npz["steps"]):
    grads = tree(*(torch.from_numpy(grads_npz[f"g_{rank}_{step}_{i}"])
                   for i in range(3)))
    if errs is None:
        errs = tree(*(torch.zeros_like(g) for g in leaves(grads)))
    reduced, errs = compress.compressed_psum_tree(grads, errs)
    for i, (r, e) in enumerate(zip(leaves(reduced), leaves(errs))):
        saved[f"reduced_{step}_{i}"] = r.numpy()
        saved[f"err_{step}_{i}"] = e.numpy()
dist.destroy_process_group()
np.savez(sys.argv[5], **saved)
"""

#: the reference over every rank at once, one device a rank:
#: argv = grads.npz, out.npz
_REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.distributed.compress import compressed_psum_tree
grads_npz = np.load(sys.argv[1])
ranks, steps = int(grads_npz["ranks"]), int(grads_npz["steps"])
assert len(jax.devices()) == ranks, jax.devices()
mesh = Mesh(np.array(jax.devices()), ("d",))
def body(g, e):
    g, e = (jax.tree.map(lambda a: a[0], t) for t in (g, e))
    r, ne = compressed_psum_tree(g, e, "d")
    return r, jax.tree.map(lambda a: a[None], ne)
f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("d"), P("d")),
                      out_specs=(P(), P("d"))))
errs = None
saved = {}
for step in range(steps):
    grads = [jnp.asarray(np.stack([grads_npz[f"g_{r}_{step}_{i}"]
                                   for r in range(ranks)]))
             for i in range(3)]
    if errs is None:
        errs = [jnp.zeros(g.shape, jnp.float32) for g in grads]
    reduced, errs = f(grads, errs)
    for i in range(3):
        saved[f"reduced_{step}_{i}"] = np.asarray(reduced[i])
np.savez(sys.argv[2], **saved)
"""


def _run_all(cmds, timeout):
    """Start every command, wait for all within ``timeout`` seconds, kill
    whatever is left; -> [(returncode, stderr)]."""
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for cmd, env in cmds]
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            out.append((p.returncode, err[-3000:]))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a spawned process outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return out


def test_four_gloo_ranks_match_reference_shard_map(tmp_path):
    """Four gloo ranks on the CPU against the reference's
    ``compressed_psum_tree`` under ``shard_map`` on four host devices,
    three steps carrying the error, on a three-leaf tree."""
    grads_npz = tmp_path / "grads.npz"
    np.savez(grads_npz, ranks=RANKS, steps=STEPS, **{
        f"g_{r}_{step}_{i}": a for r in range(RANKS) for step in range(STEPS)
        for i, a in enumerate(_rank_grads(r, step))})
    base = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
                GLOO_SOCKET_IFNAME="lo")
    ranks = [([sys.executable, "-c", _RANK_SCRIPT, str(r), str(RANKS),
               str(tmp_path / "store"), str(grads_npz),
               str(tmp_path / f"rank{r}.npz")], base) for r in range(RANKS)]
    jax_env = dict(base, JAX_PLATFORMS="cpu", XLA_FLAGS=
                   f"--xla_force_host_platform_device_count={RANKS}")
    reference = ([sys.executable, "-c", _REF_SCRIPT, str(grads_npz),
                  str(tmp_path / "ref.npz")], jax_env)
    results = _run_all(ranks + [reference], SPAWN_TIMEOUT_S)
    for code, err in results:
        assert code == 0, err
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(RANKS)]
    want = np.load(tmp_path / "ref.npz")
    errs = [[np.zeros(s, np.float32) for _, s, _ in LEAVES]
            for _ in range(RANKS)]
    quant_jit = jax.jit(jc.quantize)
    for step in range(STEPS):
        grads = [_rank_grads(r, step) for r in range(RANKS)]
        for i, (_, shape, _) in enumerate(LEAVES):
            near_tie = np.zeros(-(-int(np.prod(shape)) // 256), bool)
            step_size = np.zeros_like(near_tie, dtype=np.float32)
            for r in range(RANKS):
                corrected = grads[r][i] + errs[r][i]
                jq, js = jc.quantize(jnp.asarray(corrected))
                tq, ts = tc.quantize(torch.from_numpy(corrected))
                _assert_same_quant(tq.numpy(), ts.numpy(), jq, js)
                new_err = corrected - np.asarray(jc.dequantize(jq, js, shape))
                np.testing.assert_array_equal(
                    _bits(got[r][f"err_{step}_{i}"]), _bits(new_err))
                errs[r][i] = new_err
                near_tie |= _bits(quant_jit(corrected)[1]) != _bits(js)
                step_size = np.maximum(step_size, np.asarray(js) / RANKS)
            reduced = [g[f"reduced_{step}_{i}"] for g in got]
            for r in range(1, RANKS):
                np.testing.assert_array_equal(reduced[r], reduced[0])
            ref_red = want[f"reduced_{step}_{i}"]
            allow = (1e-6 * np.abs(ref_red).max()
                     + np.repeat(np.where(near_tie, step_size, 0), 256)
                     [:ref_red.size].reshape(shape))
            assert np.all(np.abs(reduced[0] - ref_red) <= allow), (step, i)


def test_cuda_int8_quantize_matches_plain_version():
    """The CUDA kernel against its plain version on the card, bit for bit:
    every special input above, and a view starting one element into its
    storage (not 16-byte aligned); a CUDA tensor launches (the counter
    moves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    n0 = kq8.int8_quantize_launches.count
    xs = [torch.from_numpy(np.asarray(_special(name), np.float32)).cuda()
          for name in SPECIAL if name != "empty"]
    xs.append(xs[SPECIAL.index("ragged")][1:])
    for x in xs:
        tq, ts = ops.int8_quantize(x)
        pq, ps = ref.int8_quant_ref(x)
        _assert_same_quant(tq.cpu().numpy(), ts.cpu().numpy(),
                           pq.cpu().numpy(), ps.cpu().numpy())
    assert kq8.int8_quantize_launches.count == n0 + len(xs)
