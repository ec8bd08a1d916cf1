"""Plain PyTorch pieces shared by the benchmark's references.

Everything here is written from the published descriptions of the layers
(RMSNorm, LayerNorm, rotary embeddings that rotate the two halves of a
head, softmax attention with grouped key/value heads, Whisper's
sinusoids, the tanh GELU, SwiGLU, AdamW with global-norm clipping), in
float32 by default.  Nothing here imports the program under test or its
kernels.

``prec`` says how a matrix product is computed: ``"f32"`` is the
reference, float32 with TF32 off (``strict_f32``); ``"fp8"`` is the
correctness control, the same code with both operands of every matrix
product rounded to float8 e4m3 (one scale a tensor, from its largest
magnitude) in the forward pass, the gradient passed straight through.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

#: largest finite float8 e4m3 magnitude
E4M3_MAX = 448.0


@contextlib.contextmanager
def strict_f32() -> Iterator[None]:
    """float32 matrix products in float32 (TF32 off) inside the block;
    the previous settings restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale (amax -> 448),
    returned in x's dtype; the gradient passes straight through."""
    if x.numel() == 0:
        return x
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b at ``prec``."""
    if prec == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    return torch.matmul(a, b)


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor], prec: str):
    """x @ w (+ b): weights stored (d_in, d_out)."""
    y = mm(x, p["w"], prec)
    return y + p["b"] if "b" in p else y


def rms_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * p["scale"]


def layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B,S,heads,D) at positions 0..S-1, the two
    halves of each head rotated against each other."""
    S, D = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                  device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def sinusoids(n: int, d: int, device) -> torch.Tensor:
    """Whisper's (n, d) position table: sines of the first d/2 columns,
    cosines of the rest, timescales 10000^(-i / (d/2 - 1))."""
    half = d // 2
    inc = math.log(10_000.0) / max(half - 1, 1)
    inv = torch.exp(-inc * torch.arange(half, dtype=torch.float32,
                                        device=device))
    t = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cat([t.sin(), t.cos()], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x.pow(3))))


def attention(q, k, v, *, causal: bool, prec: str) -> torch.Tensor:
    """Softmax attention: q (B,Sq,H,D) over k, v (B,Skv,K,D), query head
    h reading key/value head h // (H/K), scores over sqrt(D), query i
    seeing keys 0..i when ``causal`` -> (B,Sq,H,D)."""
    H, K, D = q.shape[2], k.shape[2], q.shape[3]
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), prec) / math.sqrt(D)
    if causal:
        Sq, Skv = s.shape[-2], s.shape[-1]
        keep = torch.ones(Sq, Skv, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v.transpose(1, 2), prec).transpose(1, 2)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean next-token cross entropy over every position."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


# --------------------------------------------------------------------------
# parameters: layout, initial values, trees
# --------------------------------------------------------------------------
#: one parameter: (path in the tree, shape, (kind, std)); kind is
#: "normal" (mean 0, the given std), "ones" or "zeros"
Leaf = Tuple[Tuple, Tuple[int, ...], Tuple[str, float]]


def dense_leaves(prefix: Tuple, d_in: int, d_out: int, bias: bool,
                 std: float = None) -> List[Leaf]:
    out = [(prefix + ("w",), (d_in, d_out),
            ("normal", 1.0 / math.sqrt(d_in) if std is None else std))]
    if bias:
        out.append((prefix + ("b",), (d_out,), ("normal", 0.02)))
    return out


def norm_leaves(prefix: Tuple, d: int, with_bias: bool) -> List[Leaf]:
    out = [(prefix + ("scale",), (d,), ("ones", 0.0))]
    if with_bias:
        out.append((prefix + ("bias",), (d,), ("zeros", 0.0)))
    return out


def build_tree(items: Sequence[Tuple[Tuple, torch.Tensor]]):
    """A nest of dicts from (path, tensor) pairs; a dict whose keys are
    the integers 0..n-1 becomes a list."""
    root: Dict = {}
    for path, value in items:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def get(tree, path: Tuple):
    for key in path:
        tree = tree[key]
    return tree


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def adamw(params: List[torch.Tensor], grads: List[torch.Tensor],
          m: List[torch.Tensor], v: List[torch.Tensor], t: int, lr: float,
          wd: float, opt: Dict[str, float]) -> None:
    """One AdamW step in place, float32: the gradients clipped to a
    global norm of ``clip_norm`` (0: no clipping), bias-corrected
    moments, decoupled weight decay p -= lr * (m̂ / (sqrt(v̂) + eps) +
    wd * p)."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    scale = 1.0
    if opt["clip_norm"]:
        norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
        scale = torch.clamp(opt["clip_norm"] / torch.clamp(norm, min=1e-9),
                            max=1.0)
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * scale
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (mi / c1) / (torch.sqrt(vi / c2) + eps) + wd * p
        p.sub_(lr * upd)


# --------------------------------------------------------------------------
# three steps of one trial
# --------------------------------------------------------------------------
def follow(loss_fn, leaves: List[Leaf], values: List[torch.Tensor],
           batches: Sequence[Dict[str, torch.Tensor]], lr: float, wd: float,
           opt: Dict[str, float], prec: str = "f32", rows: int = 2
           ) -> Dict[str, list]:
    """Train one trial from ``values`` (float32 tensors in ``leaves``'
    order, not changed) through one AdamW step a batch, the loss
    ``loss_fn(tree, batch, prec)`` a mean over the batch's rows, taken
    ``rows`` rows at a time (each block's loss and gradient weighted by
    its share of the rows).  Returns each step's loss, each leaf's
    gradient norm at the first step (before clipping) and each leaf's
    change over all the steps, as Python floats in ``leaves``' order."""
    params = [v.detach().clone().requires_grad_() for v in values]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, grad0 = [], None
    with strict_f32():
        for t, batch in enumerate(batches, start=1):
            tree = build_tree([(leaf[0], p) for leaf, p in zip(leaves, params)])
            n = next(iter(batch.values())).shape[0]
            loss, grads = 0.0, None
            for lo in range(0, n, rows):
                part = {k: x[lo: lo + rows] for k, x in batch.items()}
                share = part["tokens"].shape[0] / n
                block = loss_fn(tree, part, prec) * share
                g = torch.autograd.grad(block, params)
                grads = list(g) if grads is None else [
                    a.add_(b) for a, b in zip(grads, g)]
                loss += float(block.detach())
                del block, g
            losses.append(loss)
            if grad0 is None:
                grad0 = [float(g.norm()) for g in grads]
            with torch.no_grad():
                adamw(params, grads, m, v, t, lr, wd, opt)
            del grads, tree
        with torch.no_grad():
            change = [float((p - p0).norm()) for p, p0 in zip(params, values)]
    return {"loss": losses, "grad": grad0, "change": change}
