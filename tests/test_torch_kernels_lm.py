"""The port's LM kernel layer against the JAX reference.

The torch oracles ``flash_attention_ref`` and ``rglru_scan_ref`` are held
against the JAX oracles of the same name and against the Pallas kernels
run in interpret mode (small tiles, as ``tests/test_kernels.py`` runs
them), on the same numpy-made inputs: causal, windowed, softcapped,
grouped-query and ragged (Sq ≠ Skv, lengths that are not tile multiples)
attention in float32 and bfloat16, and the RG-LRU recurrence, also
against the ``associative_scan`` the reference model runs.  The CUDA
kernels run only on the card: their test skips here.  What the bf16
tensor-core kernel computes in its own order (64-key tiles, bf16 Q.K^T
with float32 sums, online softmax, P split in two bf16 parts for P.V) is
emulated in plain torch and held against the JAX oracle within the
limit the card holds the kernel to; with a single bf16 P it must not
stay within it.  The RG-LRU kernel's chunked order (64-step tiles,
16-step sub-chunks, the carry passed from tile to tile) is emulated too
and held against the JAX oracle and the Pallas kernel.

The backward: the plain gradients (``flash_attention_bwd_ref``,
``rglru_scan_bwd_ref``) against ``jax.vjp`` of the JAX oracles; the
``autograd.Function``s of ``ops`` on the CPU against torch.autograd
through the plain forwards; their vmap rules under
``torch.func.vmap(torch.func.grad(...))`` (one wrapper call for every
trial) against a loop over trials; and the wrappers' refusal of inputs
that require grad outside their Function.  The backward kernels, like
the forward ones, run only on the card; what the bf16 ones compute in
their own order (64 x 64 tiles of the band, P and dS split in two bf16
parts, each query head's share of dK and dV summed over its group in
order) is emulated in plain torch and held against the JAX float32 vjp
within the card's limit, and with a single bf16 P and dS must not stay
within it.

Tolerances: float32 results 2e-5 absolute on O(1) outputs (both sides
compute in float32, in other orders); bfloat16 results 2e-2 absolute —
both sides compute in float32 from the same bfloat16 inputs and round
once, so they differ by at most one bfloat16 step (2^-7 relative) of
outputs below 2 in magnitude.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as krg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread is enough, and the suite runs
    beside other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, Sq, Skv, H, K, D, causal, window, softcap)
FLASH_CASES = {
    "mha_causal": (1, 64, 64, 4, 4, 16, True, 0, 0.0),
    "gqa_ragged": (2, 70, 70, 8, 2, 32, True, 0, 0.0),
    "mqa_window": (1, 100, 100, 6, 1, 64, True, 16, 0.0),
    "window_wider_than_tile": (1, 90, 90, 2, 1, 16, True, 40, 0.0),
    "softcap": (1, 64, 64, 2, 2, 16, True, 0, 20.0),
    "noncausal_softcap": (2, 48, 48, 4, 2, 16, False, 0, 5.0),
    "sq_lt_skv": (1, 40, 72, 4, 2, 16, True, 0, 0.0),
    "sq_gt_skv_window": (1, 72, 40, 4, 1, 16, True, 48, 0.0),
    "noncausal_window": (1, 56, 56, 2, 2, 16, False, 12, 0.0),
}
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (None, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _flash_inputs(case, dtype, seed=0):
    B, Sq, Skv, H, K, D = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D))]
    _, jdt, tdt, _ = DTYPES[dtype]
    jx = [jnp.asarray(a, jdt) for a in arrs]
    # the same rounded values on both sides
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in jx]
    return jx, tx


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_oracle_matches_jax_oracle(name, dtype):
    case = FLASH_CASES[name]
    causal, window, softcap = case[6:]
    jx, tx = _flash_inputs(case, dtype)
    want = jref.flash_attention_ref(*jx, causal=causal, window=window,
                                    softcap=softcap)
    got = ref.flash_attention_ref(*tx, causal=causal, window=window,
                                  softcap=softcap)
    assert got.dtype == tx[0].dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=DTYPES[dtype][3])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_oracle_matches_pallas_interpret(name, dtype):
    """The Pallas kernel with 32-row tiles: its band skipping and its
    online softmax agree with the port's dense oracle."""
    case = FLASH_CASES[name]
    causal, window, softcap = case[6:]
    jx, tx = _flash_inputs(case, dtype, seed=1)
    want = pallas_flash(*jx, causal=causal, window=window, softcap=softcap,
                        bq=32, bk=32, interpret=True)
    got = ops.flash_attention(*tx, causal=causal, window=window,
                              softcap=softcap)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=DTYPES[dtype][3])


def _scan_inputs(B, S, R, seed=0):
    rng = np.random.default_rng(seed)
    la = (-np.abs(rng.normal(0, 0.5, (B, S, R)))).astype(np.float32)
    b = rng.normal(0, 1, (B, S, R)).astype(np.float32)
    return la, b


SCAN_SHAPES = [(1, 64, 32), (2, 100, 96), (1, 257, 520)]
#: S past a whole number of the kernel's time tiles, and S within one
SCAN_TILE_EDGES = [(2, 150, 40), (1, 40, 24)]


@pytest.mark.parametrize("B,S,R", SCAN_SHAPES)
def test_rglru_oracle_matches_jax(B, S, R):
    """Against the sequential JAX oracle (same order, float32:
    1e-5), the Pallas kernel in interpret mode (1e-5) and the reference
    model's associative_scan, whose tree order rounds differently (1e-4
    relative to the largest |h|, which is O(10) here)."""
    la, b = _scan_inputs(B, S, R)
    got = ops.rglru_scan(torch.from_numpy(la), torch.from_numpy(b)).numpy()
    seq = np.asarray(jref.rglru_scan_ref(jnp.asarray(la), jnp.asarray(b)))
    np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)
    pal = np.asarray(pallas_rglru(jnp.asarray(la), jnp.asarray(b), bt=32,
                                  bf=64, interpret=True))
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)

    def op(c1, c2):
        (la1, h1), (la2, h2) = c1, c2
        return la1 + la2, h1 * jnp.exp(la2) + h2
    _, assoc = jax.lax.associative_scan(op, (jnp.asarray(la), jnp.asarray(b)),
                                        axis=1)
    assoc = np.asarray(assoc)
    assert np.abs(got - assoc).max() <= 1e-4 * np.abs(assoc).max()


def test_rglru_oracle_initial_state():
    la, b = _scan_inputs(2, 20, 8, seed=3)
    h0 = np.random.default_rng(4).normal(0, 1, (2, 8)).astype(np.float32)
    got = ref.rglru_scan_ref(torch.from_numpy(la), torch.from_numpy(b),
                             torch.from_numpy(h0)).numpy()
    want = np.asarray(jref.rglru_scan_ref(jnp.asarray(la), jnp.asarray(b),
                                          jnp.asarray(h0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    jx, (q, k, v) = _flash_inputs(FLASH_CASES["mqa_window"], "f32")
    la, b = (torch.from_numpy(a) for a in _scan_inputs(1, 30, 16))
    n_fa = kfa.flash_attention_launches.count
    n_rg = krg.rglru_scan_launches.count
    assert torch.equal(kfa.flash_attention(q, k, v, window=16),
                       ref.flash_attention_ref(q, k, v, window=16))
    assert torch.equal(krg.rglru_scan(la, b), ref.rglru_scan_ref(la, b))
    assert kfa.flash_attention_launches.count == n_fa
    assert krg.rglru_scan_launches.count == n_rg


def _op_cases():
    """(op, args) of ``ops.flash_attention``, ``ops.rglru_scan`` and
    ``ops.int8_quantize`` on CPU tensors, with their plain versions."""
    _, (q, k, v) = _flash_inputs(FLASH_CASES["mqa_window"], "f32")
    la, b = (torch.from_numpy(a) for a in _scan_inputs(1, 30, 16))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(700)
                         .astype(np.float32))
    return {
        "flash_attention": (lambda **kw: ops.flash_attention(
            q, k, v, window=16, **kw),
            lambda: ref.flash_attention_ref(q, k, v, window=16)),
        "rglru_scan": (lambda **kw: ops.rglru_scan(la, b, **kw),
                       lambda: ref.rglru_scan_ref(la, b)),
        "int8_quantize": (lambda **kw: ops.int8_quantize(x, **kw),
                          lambda: ref.int8_quant_ref(x, 256)),
    }


@pytest.mark.parametrize("name", ["flash_attention", "rglru_scan",
                                  "int8_quantize"])
def test_ops_force_kernel_needs_a_cuda_tensor(name):
    """``force_kernel`` is accepted as the reference's ops accept it: by
    default a CPU tensor takes the plain version; ``force_kernel=True``
    asks for the hand-written kernel, which on a CPU tensor raises
    rather than quietly running the plain version in its place."""
    op, plain = _op_cases()[name]
    as_tuple = lambda t: t if isinstance(t, tuple) else (t,)  # noqa: E731
    want = as_tuple(plain())
    for got in (as_tuple(op()), as_tuple(op(force_kernel=False))):
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="force_kernel=True"):
        op(force_kernel=True)


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_padded_head_dims_match_the_plain_version(name):
    """What a wrapper does on the card with a head dim between the
    instantiated ones (``gqa_ragged``'s D 32 runs at 64): q, k, v
    zero-padded, the true width's scale, o, lse and the gradients cut
    back.  Here the padded call is the plain version, padded to the next
    width past D, held to the unpadded plain version (float32, 2e-5)."""
    case = FLASH_CASES[name]
    causal, window, softcap = case[6:]
    kw = dict(causal=causal, window=window, softcap=softcap)
    D = case[5]
    Dp = kfa.kernel_head_dim(D + 1)
    _, (q, k, v) = _flash_inputs(case, "f32")
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    got_o, got_lse = kfa.padded_forward(ref.flash_attention_ref, q, k, v,
                                        Dp, return_lse=True, **kw)
    assert got_o.shape == o.shape and Dp > D
    torch.testing.assert_close(got_o, o, rtol=0, atol=2e-5)
    torch.testing.assert_close(got_lse, lse, rtol=0, atol=2e-5)
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(o.shape)).astype(np.float32))
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    got = kfa.padded_backward(ref.flash_attention_bwd_ref, q, k, v, o, lse,
                              do, Dp, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5)


def test_kernel_head_dim_pads_to_the_next_instantiation():
    assert [kfa.kernel_head_dim(d) for d in (1, 16, 17, 32, 64, 65, 128,
                                             192, 256)] == \
        [16, 16, 64, 64, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="wider than 256"):
        kfa.kernel_head_dim(257)


def test_wrappers_raise_on_a_device_without_a_kernel():
    _, (q, k, v) = _flash_inputs(FLASH_CASES["mha_causal"], "f32")
    with pytest.raises(ValueError, match="no kernel"):
        kfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    la, b = (torch.from_numpy(a).to("meta") for a in _scan_inputs(1, 8, 4))
    with pytest.raises(ValueError, match="no kernel"):
        krg.rglru_scan(la, b)


def test_cuda_kernels_match_plain_versions():
    """The hand-written CUDA kernels against their plain versions on the
    card, every case above in float32 and bfloat16, with the tolerances
    above; and a CUDA tensor launches (the counters move)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    n0 = kfa.flash_attention_launches.count
    for name, case in FLASH_CASES.items():
        causal, window, softcap = case[6:]
        for dtype in DTYPES:
            _, tx = _flash_inputs(case, dtype)
            q, k, v = (t.to(dev) for t in tx)
            got = kfa.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=softcap)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, softcap=softcap)
            err = float((got.float() - want.float()).abs().max())
            assert err <= DTYPES[dtype][3], (name, dtype, err)
    assert kfa.flash_attention_launches.count == n0 + 2 * len(FLASH_CASES)
    for B, S, R in SCAN_SHAPES + SCAN_TILE_EDGES + [(2, 1, 1000),
                                                    (3, 65, 1000),
                                                    (2, 129, 999)]:
        la, b = (torch.from_numpy(a).to(dev) for a in _scan_inputs(B, S, R))
        got = krg.rglru_scan(la, b)
        want = ref.rglru_scan_ref(la, b)
        assert float((got - want).abs().max()) <= 1e-5 * max(
            1.0, float(want.abs().max()))


# ----------------------------------------------- the bf16 kernel's arithmetic
#: the element-wise limit chip_smoke.py holds the bf16 kernel to (its
#: FLASH_TOL["bfloat16"]): |out - ref32| <= 2^-8 |ref32| + 2^-10 rms(row)
BF16_TOL = (2.0 ** -8, 2.0 ** -10)
# (B, Sq, Skv, H, K, D, causal, window, softcap)
EMULATED_CASES = {
    "causal_d64": (1, 256, 256, 2, 1, 64, True, 0, 0.0),
    "ragged_noncausal_d16": (2, 150, 200, 4, 2, 16, False, 0, 0.0),
    "gqa_window": (1, 300, 300, 4, 1, 32, True, 100, 0.0),
    "softcap": (1, 200, 200, 2, 2, 64, True, 0, 20.0),
}


def _tensor_core_flash(q, k, v, causal, window, softcap, split=True):
    """Plain-torch emulation of the bf16 tensor-core kernel's arithmetic
    (``csrc/flash_attention.cu`` ``tc::flash_tc_kernel``): per 64 query
    rows (one consumer warpgroup), the 64-key tiles of its band in order;
    Q.K^T of the bf16 inputs with float32 sums, scale, softcap, mask,
    online softmax in float32; P.V with P split in P_hi = bf16(P) and
    P_lo = bf16(P - P_hi) (``split=False``: P_hi alone); l sums the
    float32 P; out rounded once to bf16."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                          # (B, H, Sq, D)
    kf = k.float().transpose(1, 2).repeat_interleave(H // K, 1)
    vf = v.float().transpose(1, 2).repeat_interleave(H // K, 1)
    out = torch.zeros(B, H, Sq, D)
    for r0 in range(0, Sq, 64):
        r1 = min(r0 + 64, Sq)
        lo = max(0, r0 - window + 1) if window else 0
        hi = min(r1, Skv) if causal else Skv
        m = torch.full((B, H, r1 - r0, 1), ref.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, r1 - r0, D)
        qp = torch.arange(r0, r1)[:, None]
        for t in range(lo // 64, -(-hi // 64)):
            k0, k1 = 64 * t, min(64 * t + 64, Skv)
            s = (qf[:, :, r0:r1] @ kf[:, :, k0:k1].transpose(-1, -2)
                 / math.sqrt(D))
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            kp = torch.arange(k0, k1)[None, :]
            ok = torch.ones((r1 - r0, k1 - k0), dtype=torch.bool)
            if causal:
                ok &= qp >= kp
            if window:
                ok &= (qp - kp) < window
            s = torch.where(ok, s, torch.tensor(ref.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            p_hi = p.bfloat16().float()
            acc = acc * alpha + p_hi @ vf[:, :, k0:k1]
            if split:
                acc = acc + (p - p_hi).bfloat16().float() @ vf[:, :, k0:k1]
            m = m_new
        out[:, :, r0:r1] = acc / l.clamp(min=1e-30)
    return out.transpose(1, 2).bfloat16()


def _excess(out, ref32):
    """Largest ratio of |out - ref32| to the BF16_TOL element limit."""
    rtol, c = BF16_TOL
    rms = ref32.square().mean(-1, keepdim=True).sqrt()
    lim = rtol * ref32.abs() + c * rms
    return float(((out.float() - ref32).abs() / lim).max())


def _emulated_case(name):
    case = EMULATED_CASES[name]
    causal, window, softcap = case[6:]
    jx, tx = _flash_inputs(case, "bf16", seed=5)
    ref32 = torch.from_numpy(np.array(jref.flash_attention_ref(
        *(a.astype(jnp.float32) for a in jx), causal=causal, window=window,
        softcap=softcap)))
    return tx, (causal, window, softcap), ref32


@pytest.mark.parametrize("name", list(EMULATED_CASES))
def test_tensor_core_arithmetic_within_the_bf16_limit(name):
    """The bf16 kernel's arithmetic (split P) stays within the limit the
    card holds the kernel to, against the JAX float32 oracle on the same
    bf16 inputs."""
    tx, opts, ref32 = _emulated_case(name)
    assert _excess(_tensor_core_flash(*tx, *opts), ref32) <= 1.0


@pytest.mark.parametrize("name", list(EMULATED_CASES))
def test_single_bf16_probabilities_exceed_the_bf16_limit(name):
    """Why P is split: one bf16 rounding of P (2^-9/sqrt(3) of the row's
    rms an element) does not stay within the same limit."""
    tx, opts, ref32 = _emulated_case(name)
    assert _excess(_tensor_core_flash(*tx, *opts, split=False), ref32) > 1.0


# ---------------------------------- the bf16 backward kernels' arithmetic
#: the forward's emulated cases, and one at D = 256 with G = H/K > 1
EMULATED_BWD_CASES = {
    **EMULATED_CASES,
    "gqa_d256": (2, 160, 160, 4, 2, 256, True, 96, 0.0),
}
#: chip_smoke.py's BWD_FLOOR: the backward's absolute floor, a share of
#: the largest gradient's rms
BWD_FLOOR = 1e-4


def _two_parts(x, split):
    """x as the kernels feed it to a second product: bf16(x), plus
    bf16(x - bf16(x)) when split."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def _tile_grads(q, do, k, v, lse, dvec, q0, k0, opts, Sq, Skv):
    """P and dS of one (query tile, key tile) pair of one or more heads:
    S and dP float32 sums of the bf16 inputs' products, scale, softcap,
    P = exp(s - lse) and 0 where masked, dS = P (dP - D) (1 - tanh^2) /
    sqrt(D)."""
    causal, window, softcap = opts
    scale = 1.0 / math.sqrt(q.shape[-1])
    x = q @ k.transpose(-1, -2) * scale
    dcap = 1.0
    if softcap:
        t = torch.tanh(x / softcap)
        x, dcap = t * softcap, 1.0 - t * t
    qp = torch.arange(q0, q0 + q.shape[-2])[:, None]
    kp = torch.arange(k0, k0 + k.shape[-2])[None, :]
    ok = (qp < Sq) & (kp < Skv)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= (qp - kp) < window
    p = torch.where(ok, torch.exp(x - lse[..., None]), torch.zeros(()))
    ds = p * dcap * scale * (do @ v.transpose(-1, -2) - dvec[..., None])
    return p, ds


def _tensor_core_flash_bwd(q, k, v, o, lse, do, causal, window, softcap,
                           split=True):
    """Plain-torch emulation of the bf16 backward kernels' arithmetic
    (``csrc/flash_attention.cu`` ``bwd::dkdv_tc_kernel``,
    ``bwd::dq_tc_kernel``): D = rowsum(dO O) in float32; per 64-key tile
    and query head, the 64-row query tiles of the keys' band in order,
    dV += P^T.dO and dK += dS^T.Q with P and dS split in two bf16 parts
    (``split=False``: the first alone), each head's float32 share then
    summed over the heads of its KV head in order; per 64 query rows the
    64-key tiles of their band, dQ += dS.K with dS split; each gradient
    rounded once to bf16."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    opts = (causal, window, softcap)
    qf, dof = (t.float().transpose(1, 2) for t in (q, do))  # (B, H, Sq, D)
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(G, 1)
              for t in (k, v))
    dvec = (do.float() * o.float()).sum(-1).transpose(1, 2)  # (B, H, Sq)
    part_k = torch.zeros(B, H, Skv, D)
    part_v = torch.zeros(B, H, Skv, D)
    for k0 in range(0, Skv, 64):
        k1 = min(k0 + 64, Skv)
        lo = k0 if causal else 0
        hi = min(Sq, k1 - 1 + window) if window else Sq
        for q0 in range(lo // 64 * 64, hi if lo < hi else 0, 64):
            q1 = min(q0 + 64, Sq)
            p, ds = _tile_grads(qf[:, :, q0:q1], dof[:, :, q0:q1],
                                kf[:, :, k0:k1], vf[:, :, k0:k1],
                                lse[:, :, q0:q1], dvec[:, :, q0:q1], q0, k0,
                                opts, Sq, Skv)
            part_v[:, :, k0:k1] += (_two_parts(p, split).transpose(-1, -2)
                                    @ dof[:, :, q0:q1])
            part_k[:, :, k0:k1] += (_two_parts(ds, split).transpose(-1, -2)
                                    @ qf[:, :, q0:q1])
    dk = torch.zeros(B, K, Skv, D)
    dv = torch.zeros(B, K, Skv, D)
    for g in range(G):
        dk = dk + part_k.reshape(B, K, G, Skv, D)[:, :, g]
        dv = dv + part_v.reshape(B, K, G, Skv, D)[:, :, g]
    dq = torch.zeros(B, H, Sq, D)
    for r0 in range(0, Sq, 64):
        r1 = min(r0 + 64, Sq)
        lo = max(0, r0 - window + 1) if window else 0
        hi = min(r1, Skv) if causal else Skv
        for k0 in range(lo // 64 * 64, hi if lo < hi else 0, 64):
            k1 = min(k0 + 64, Skv)
            _, ds = _tile_grads(qf[:, :, r0:r1], dof[:, :, r0:r1],
                                kf[:, :, k0:k1], vf[:, :, k0:k1],
                                lse[:, :, r0:r1], dvec[:, :, r0:r1], r0, k0,
                                opts, Sq, Skv)
            dq[:, :, r0:r1] += _two_parts(ds, split) @ kf[:, :, k0:k1]
    return tuple(t.transpose(1, 2).bfloat16() for t in (dq, dk, dv))


def _bwd_excess(got, want):
    """chip_smoke.py's ``bwd_excess``: the largest ratio, over (dq, dk,
    dv), of |got - want| to the BF16_TOL element limit plus BWD_FLOOR
    times the largest rms of the three."""
    rtol, c = BF16_TOL
    floor = BWD_FLOOR * max(float(w.square().mean().sqrt()) for w in want)
    worst = 0.0
    for g, w in zip(got, want):
        rms = w.square().mean(-1, keepdim=True).sqrt()
        lim = rtol * w.abs() + c * rms + floor
        worst = max(worst, float(((g.float() - w).abs() / lim).max()))
    return worst


def _emulated_bwd_case(name):
    """bf16 q, k, v, dO; the JAX float32 vjp on their values; the float32
    o that vjp uses (the kernels read the forward's bf16 o, and the card's
    plain version reads that same o: its rounding is the caller's, not
    this arithmetic's) and the row lse."""
    case = EMULATED_BWD_CASES[name]
    causal, window, softcap = case[6:]
    jx = [jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)
          for a in _bwd_inputs(case, seed=5)]
    o, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, window=window, softcap=softcap), *jx[:3])
    want = [torch.from_numpy(np.array(w)) for w in vjp(jx[3])]
    q, k, v, do = (torch.from_numpy(np.array(a)).bfloat16() for a in jx)
    _, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     softcap=softcap, return_lse=True)
    args = (q, k, v, torch.from_numpy(np.array(o)), lse, do)
    return args, (causal, window, softcap), want


@pytest.mark.parametrize("name", list(EMULATED_BWD_CASES))
def test_tensor_core_backward_within_the_bf16_limit(name):
    """The bf16 backward kernels' arithmetic (P and dS split, the heads'
    shares summed in order) stays within the limit the card holds them to
    (chip_smoke.py's FLASH_TOL["bfloat16"] plus BWD_FLOOR), against the
    JAX float32 vjp on the same bf16 inputs."""
    args, opts, want = _emulated_bwd_case(name)
    assert _bwd_excess(_tensor_core_flash_bwd(*args, *opts), want) <= 1.0


@pytest.mark.parametrize("name", list(EMULATED_BWD_CASES))
def test_single_bf16_p_and_ds_exceed_the_bf16_limit(name):
    """Why the kernels split P and dS: one bf16 rounding of them does not
    stay within the same limit."""
    args, opts, want = _emulated_bwd_case(name)
    assert _bwd_excess(_tensor_core_flash_bwd(*args, *opts, split=False),
                       want) > 1.0


# ------------------------------------------- the chunked scan's arithmetic
def _chunked_scan(log_a, b, tile=krg.TIME_TILE, sub=krg.SUB_CHUNK):
    """Plain-torch emulation of the ``rglru_scan`` kernel's order
    (``csrc/rglru_scan.cu``): time in tiles of ``tile`` steps (padded with
    a = 1, b = 0), each in sub-chunks of ``sub`` steps scanned from 0 to a
    pair (A = prod a, H = the end state), the pairs folded into the
    tile's; a tile's carry-in is the state after the tile before,
    A·carry + H, and then each sub-chunk runs again from its carry-in (the
    tile's carry through the sub-chunks before it)."""
    B, S, R = log_a.shape
    n = -(-S // tile)
    pad = n * tile - S
    a = torch.exp(torch.nn.functional.pad(log_a, (0, 0, 0, pad)))
    bb = torch.nn.functional.pad(b, (0, 0, 0, pad))
    nsub = tile // sub
    sub_a = torch.ones(n, nsub, B, R)
    sub_h = torch.zeros(n, nsub, B, R)
    for i in range(n):
        for q in range(nsub):
            for t in range(i * tile + q * sub, i * tile + (q + 1) * sub):
                sub_h[i, q] = sub_h[i, q] * a[:, t] + bb[:, t]
                sub_a[i, q] = sub_a[i, q] * a[:, t]
    carry = torch.zeros(n, B, R)
    for i in range(n):
        tile_a, tile_h = torch.ones(B, R), torch.zeros(B, R)
        for q in range(nsub):
            tile_h = sub_a[i, q] * tile_h + sub_h[i, q]
            tile_a = tile_a * sub_a[i, q]
        if i + 1 < n:
            carry[i + 1] = tile_a * carry[i] + tile_h
    out = torch.empty(B, n * tile, R)
    for i in range(n):
        for q in range(nsub):
            h = carry[i]
            for qq in range(q):
                h = sub_a[i, qq] * h + sub_h[i, qq]
            for t in range(i * tile + q * sub, i * tile + (q + 1) * sub):
                h = h * a[:, t] + bb[:, t]
                out[:, t] = h
    return out[:, :S]


@pytest.mark.parametrize("B,S,R", SCAN_SHAPES + SCAN_TILE_EDGES)
def test_chunked_scan_order_matches_reference(B, S, R):
    """The kernel's chunked order against the sequential JAX oracle and
    the Pallas kernel in interpret mode, with the tolerance of
    ``test_rglru_oracle_matches_jax`` (1e-5): S a whole number of tiles,
    past one, and within one."""
    la, b = _scan_inputs(B, S, R, seed=S)
    got = _chunked_scan(torch.from_numpy(la), torch.from_numpy(b)).numpy()
    seq = np.asarray(jref.rglru_scan_ref(jnp.asarray(la), jnp.asarray(b)))
    np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)
    pal = np.asarray(pallas_rglru(jnp.asarray(la), jnp.asarray(b), bt=32,
                                  bf=64, interpret=True))
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the backward
#: float32 gradients against jax.vjp of the JAX oracle: both sides dense
#: float32 in other orders, so 2e-5 of each tensor's largest magnitude
BWD_RTOL = 2e-5


def _bwd_inputs(case, seed):
    B, Sq, Skv, H, K, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D), (B, Sq, H, D))]


def _close_rel(got, want, rtol):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (err, rtol)


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_bwd_oracle_matches_jax_vjp(name):
    """``flash_attention_bwd_ref`` from the oracle's own lse and output,
    against ``jax.vjp`` of the JAX oracle: causal, windowed, softcapped,
    grouped-query and ragged (Sq ≠ Skv) cases."""
    case = FLASH_CASES[name]
    causal, window, softcap = case[6:]
    q, k, v, do = _bwd_inputs(case, seed=7)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, **kw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    for g, w in zip(got, want):
        _close_rel(g, w, BWD_RTOL)


@pytest.mark.parametrize("B,S,R", SCAN_SHAPES)
def test_rglru_bwd_oracle_matches_jax_vjp(B, S, R):
    """``rglru_scan_bwd_ref`` against ``jax.vjp`` of the sequential JAX
    oracle (float32, the same recurrence backwards: 1e-5 of the largest
    gradient)."""
    la, b = _scan_inputs(B, S, R, seed=S + 1)
    dh = np.random.default_rng(S).normal(0, 1, (B, S, R)).astype(np.float32)
    h, vjp = jax.vjp(jref.rglru_scan_ref, jnp.asarray(la), jnp.asarray(b))
    want = vjp(jnp.asarray(dh))
    got = ref.rglru_scan_bwd_ref(torch.from_numpy(la),
                                 torch.from_numpy(np.array(h)),
                                 torch.from_numpy(dh))
    for g, w in zip(got, want):
        _close_rel(g, w, 1e-5)


def test_lse_is_the_row_log_sum_exp():
    """The forward's lse: each row's probabilities exp(s - lse) sum to 1,
    so the backward recomputes the forward's softmax from it."""
    case = FLASH_CASES["gqa_ragged"]
    causal, window, softcap = case[6:]
    _, (q, k, v) = _flash_inputs(case, "f32", seed=2)
    o, lse = ops._FlashAttention.apply(q, k, v, causal, window, softcap,
                                       None)
    assert torch.equal(o, ops.flash_attention(q, k, v, causal=causal,
                                              window=window, softcap=softcap))
    B, Sq, H, D = q.shape
    s, _ = ref._flash_scores(q, k, causal, window, softcap)
    p = torch.exp(s - lse.reshape(s.shape[:-1])[..., None])
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=0, atol=1e-5)


AUTOGRAD_CASES = ["gqa_ragged", "mqa_window", "softcap", "sq_gt_skv_window",
                  "noncausal_window"]


@pytest.mark.parametrize("name", AUTOGRAD_CASES)
def test_flash_function_gradients_match_autograd_of_the_oracle(name):
    """``ops.flash_attention``'s autograd.Function on the CPU (the plain
    forward, lse saved, the plain backward) against torch.autograd
    through the dense oracle itself: float32, 2e-5 of the largest
    gradient."""
    case = FLASH_CASES[name]
    causal, window, softcap = case[6:]
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(case, seed=9))
    kw = dict(causal=causal, window=window, softcap=softcap)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*ins, **kw), ins, do)
    ins2 = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*ins2, **kw), ins2,
                               do)
    for g, w in zip(got, want):
        _close_rel(g, w, BWD_RTOL)


def test_rglru_function_gradients_match_autograd_of_the_oracle():
    la, b = (torch.from_numpy(a) for a in _scan_inputs(2, 70, 24, seed=4))
    dh = torch.randn(2, 70, 24, generator=torch.Generator().manual_seed(0))
    ins = [t.clone().requires_grad_() for t in (la, b)]
    got = torch.autograd.grad(ops.rglru_scan(*ins), ins, dh)
    ins2 = [t.clone().requires_grad_() for t in (la, b)]
    want = torch.autograd.grad(ref.rglru_scan_ref(*ins2), ins2, dh)
    for g, w in zip(got, want):
        _close_rel(g, w, 1e-5)


class _Calls:
    """Counts the calls of a kernel wrapper (the wrappers' launch counters
    move only on the card)."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *args, **kwargs):
        self.n += 1
        return self.fn(*args, **kwargs)


def test_vmap_rule_folds_the_trials_into_one_call(monkeypatch):
    """Under ``torch.func.vmap`` of ``torch.func.grad`` each Function's
    vmap rule folds the trial axis into the batch: one wrapper call for
    the forward and one for the backward, for all P trials, equal to a
    loop over the trials (a mapped q and v, a shared k)."""
    P = 3
    case = FLASH_CASES["gqa_ragged"]
    causal, window, softcap = case[6:]
    rng = np.random.default_rng(11)
    B, S, _, H, K, D = case[:6]
    q = torch.from_numpy(rng.standard_normal((P, B, S, H, D))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, K, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((P, B, S, K, D))
                         .astype(np.float32))
    la = torch.from_numpy(-np.abs(rng.normal(0, 0.5, (P, B, S, K * D)))
                          .astype(np.float32))
    kw = dict(causal=causal, window=window, softcap=softcap)

    def loss(q, v, la):
        o = ops.flash_attention(q, k, v, **kw)
        h = ops.rglru_scan(la, o.reshape(B, S, -1)[..., :K * D])
        return (o.square().sum() + h.sin().sum())

    calls = {n: _Calls(getattr(m, n)) for m, n in
             ((kfa, "flash_attention"), (kfa, "flash_attention_bwd"),
              (krg, "rglru_scan"), (krg, "rglru_scan_bwd"))}
    for n, c in calls.items():
        monkeypatch.setattr(kfa if n.startswith("flash") else krg, n, c)
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(q, v, la)
    assert {n: c.n for n, c in calls.items()} == {n: 1 for n in calls}
    for i in range(P):
        want = torch.func.grad(loss, argnums=(0, 1, 2))(q[i], v[i], la[i])
        for g, w in zip(got, want):
            _close_rel(g[i], w, 1e-5)


def test_flash_attention_asks_for_lse_only_under_a_gradient(monkeypatch):
    """``ops.flash_attention`` has the kernel write the row log-sum-exp
    only where a backward may read it: serving (no input needs a graph)
    calls the wrapper as before, with no lse; autograd and a
    ``torch.func`` transform go through the Function, which saves it."""
    _, (q, k, v) = _flash_inputs(FLASH_CASES["mha_causal"], "f32")
    asked = []
    real = kfa.flash_attention

    def spy(*a, return_lse=False, **kw):
        asked.append(return_lse)
        return real(*a, return_lse=return_lse, **kw)

    monkeypatch.setattr(kfa, "flash_attention", spy)
    want = real(q, k, v)
    assert torch.equal(ops.flash_attention(q, k, v), want)
    with torch.no_grad():
        ops.flash_attention(q.clone().requires_grad_(), k, v)
    assert asked == [False, False]
    ops.flash_attention(q.clone().requires_grad_(), k, v).sum().backward()
    torch.func.grad(lambda q: ops.flash_attention(q, k, v).sum())(q)
    torch.func.vmap(lambda q: ops.flash_attention(q, k, v))(q[None])
    assert asked == [False, False, True, True, True]


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd",
                                  "rglru_scan", "rglru_scan_bwd"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    """A wrapper records no graph, so reached with inputs that require
    grad outside its autograd.Function it raises (rather than hand back
    an output that silently gives them no gradient); with grad off, or
    through ``ops``, the same inputs are fine."""
    _, (q, k, v) = _flash_inputs(FLASH_CASES["mha_causal"], "f32")
    la, b = (torch.from_numpy(a) for a in _scan_inputs(1, 30, 16))
    o, lse = kfa.flash_attention(q, k, v, return_lse=True)
    calls = {
        "flash_attention": lambda g: kfa.flash_attention(g(q), k, v),
        "flash_attention_bwd": lambda g: kfa.flash_attention_bwd(
            q, k, g(v), o, lse, o),
        "rglru_scan": lambda g: krg.rglru_scan(la, g(b)),
        "rglru_scan_bwd": lambda g: krg.rglru_scan_bwd(g(la), b, b),
    }
    grad = lambda t: t.clone().requires_grad_()  # noqa: E731
    with pytest.raises(RuntimeError, match="records no graph"):
        calls[name](grad)
    with torch.no_grad():
        calls[name](grad)


def test_cuda_backward_kernels_match_plain_versions():
    """The two backward kernels against their plain versions on the card,
    every case above in float32 and bfloat16 (the plain version on the
    float32 values of the same inputs; 2e-5 of the largest gradient in
    float32, 2e-2 in bfloat16: one rounding of the output), and the scan's
    at the shapes above; the counters move once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    n0 = kfa.flash_attention_bwd_launches.count
    for name, case in FLASH_CASES.items():
        kw = dict(zip(("causal", "window", "softcap"), case[6:]))
        for dtype, (_, _, tdt, _) in DTYPES.items():
            q, k, v, do = (torch.from_numpy(a).to(dev, tdt)
                           for a in _bwd_inputs(case, seed=3))
            o, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)
            got = kfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            want = ref.flash_attention_bwd_ref(
                *(t.float() for t in (q, k, v, o)), lse, do.float(), **kw)
            for g, w in zip(got, want):
                _close_rel(g.cpu(), w.cpu(),
                           BWD_RTOL if dtype == "f32" else 2e-2)
    assert kfa.flash_attention_bwd_launches.count == n0 + 2 * len(
        FLASH_CASES)
    for B, S, R in SCAN_SHAPES + SCAN_TILE_EDGES:
        la, b = (torch.from_numpy(a).to(dev) for a in _scan_inputs(B, S, R))
        dh = torch.randn(B, S, R, device=dev)
        h = krg.rglru_scan(la, b)
        for g, w in zip(krg.rglru_scan_bwd(la, h, dh),
                        ref.rglru_scan_bwd_ref(la, h, dh)):
            _close_rel(g.cpu(), w.cpu(), 1e-5)
