"""The LM of the port, for all ten architectures of the reference.

The port's copy of the reference's ``models/model.py``:
  dense    decoder-only transformer (GQA attention, MLP); with
           ``cfg.parallel_block`` (command-r) one norm feeds attention and
           the FFN side by side, ``x + att + ffn(h)``
  hybrid   Griffin-style (RG-LRU, RG-LRU, local-attn) stacks
  ssm      xLSTM (mLSTM, mLSTM, mLSTM, sLSTM) stacks; both blocks return
           before the FFN (an sLSTM block carries its own)
  vlm      a decoder LM over precomputed (stub) patch embeddings
           ``img_embeds`` (B,n_img,d) put in front of the token
           embeddings: positions run over prefix and text, ``forward``
           drops the prefix before the unembedding, the prefill's cache
           holds it (``pos`` starts at n_img + prompt length)
  moe      decoder-only transformer (GQA or MLA attention; MoE FFN after
           ``first_dense_layers`` layers with a dense MLP)
  encdec   whisper: an encoder of ``encoder_layers`` non-causal attention
           layers over precomputed (stub) frame embeddings, sinusoidal
           positions, and a decoder of ``XATTN`` layers (self-attention,
           cross-attention over the encoder output, MLP) whose decode
           cache holds the encoder's keys and values (``ck``, ``cv``)

The reference scans homogeneous layer groups (``build_groups``) whose
parameters carry a leading ``repeats`` dim; eager PyTorch compiles
nothing, so the port keeps one flat list of layers in stack order
(``LM.specs``, ``params["layers"]``, ``cache["layers"]``), and
``models/convert.py`` unstacks reference weights (and optimizer state)
into it along the same groups (``model_groups``); the encoder's layers
are a list of their own (``params["encoder"]["layers"]``).  The card
serves and trains every family; the training is held against the
reference on the CPU, and on the card against the plain path.

API (functions of plain dicts of tensors; ``torch.func`` composes with
``forward`` and ``loss`` at every remat):
  init(seed, device, dtype) -> params
  loss(params, batch) -> (scalar, metrics)         # train_step target
  forward(params, batch) -> (logits over the text, aux)
  prefill(params, batch, cache_len) -> (cache, last_logits)
  decode_step(params, cache, tokens) -> (logits, cache)
  init_cache(batch_size, cache_len, device, enc_len=0) -> cache
  encode(params, frames) -> encoder output        # encdec only

Training rematerializes as ``cfg.remat`` says, one layer at a time (the
reference checkpoints a scanned group): "full" keeps only each layer's
input (``torch.utils.checkpoint``, non-reentrant), "dots" also keeps the
outputs of its matrix products (a selective-checkpoint policy, the
counterpart of ``dots_saveable``), "none" keeps everything.  Under "full"
every layer's forward, and so each of its kernels, runs twice a step.
Under a ``torch.func`` transform (the population's ``vmap(grad(...))``,
whose transforms refuse ``torch.utils.checkpoint``'s saved-tensor hooks)
both modes go through ``_Remat``: each layer's input kept, the layer
recomputed in the backward; "dots" keeps no matrix product there.

``init`` and ``init_cache`` make their tensors on the CUDA card unless
given ``device`` (``device.resolve``: no card and no ``device`` raises);
a cache's ``pos`` is (B,) int32, as the reference's.

Given DTensors (a sharded step, ``launch/steps.py``) the model runs
each layer as regions of plain tensors on each rank's shards, their
weights gathered (``repro_torch._dtensor``, FSDP-style), and the
embedding and the final norm with the unembedding on each rank's rows;
between them it anchors the activations to the ambient (batch, seq) spec
where the reference does (``distributed/act_sharding.py``): the
embedding, the end of each repeat of a group's pattern and the logits.
Where that spec shards the sequence too (sequence parallelism, as the
reference's ``batch_seq_spec`` lays it out when the batch does not cover
the mesh), a layer runs on each rank's (batch, sequence) shard
(``_layer_fwd_seq``): its norms, projections (RoPE at the shard's
positions), residuals and dense MLP on the shard, attention of the
shard's queries over keys and values gathered along the sequence (the
kernel told the shard's first position); the recurrent scans and the
MoE's per-sequence dispatch, which the reference anchors on their batch
alone, on the gathered sequence, their outputs returned to the shards.
A decode step over a cache sharded on its sequence attends each rank's
chunk of the slots and combines the chunks across the ranks
(``_layer_decode_chunks``); no rank gathers a layer's cache.
On plain tensors the anchors do nothing and no region is entered.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import DeviceLike, resolve
from repro_torch import _dtensor
from repro_torch._dtensor import (batch_placements, cache_chunk_dims,
                                  is_dtensor,
                                  on_batch_shards, on_cache_chunks,
                                  on_row_shards, on_row_sums, on_seq_shards,
                                  seq_placements, seq_shards)
from repro_torch.distributed.act_sharding import constrain
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models.common import (ATTN, LOCAL_ATTN, MLSTM, RGLRU,
                                       SLSTM, ModelConfig)
from repro_torch.spans import backward_span, span

Params = Dict[str, Any]

XATTN = "xattn"  # whisper decoder layer (self + cross + mlp)


class _TiedCast(torch.autograd.Function):
    """A tied table cast to ``dtype`` once, handed out twice (the
    embedding's and the unembedding's copy, one storage).  The backward
    sums the two uses' gradients in the table's dtype (float32), as
    autograd sums the
    cotangents of the reference's two casts: summed at one cast they
    would meet in ``dtype``.  Under ``torch.func.grad`` this also keeps
    the backward to one table-sized float32 gradient (two, and their sum,
    were the population's peak)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(table, dtype):
        t = L.cast_param(table, dtype)
        return t, t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dtype = inputs[0].dtype

    @staticmethod
    def backward(ctx, g_embed, g_unembed):
        g = g_embed.to(ctx.dtype)
        g.add_(g_unembed)
        return g, None


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str          # attn | local | rglru | mlstm | slstm | xattn
    ffn: str           # mlp | dense_mlp | moe | none


def model_groups(cfg: ModelConfig
                 ) -> Tuple[Tuple[Tuple[LayerSpec, ...], int], ...]:
    """The reference's layer groups (its ``build_groups``): ((pattern of
    layer specs, repeats), ...) in stack order.  An MoE stack is
    ``first_dense_layers`` x (attn, dense_mlp), then (attn, moe) for the
    rest; an encoder-decoder's decoder is ``n_layers`` x (xattn, mlp); any
    other stack follows ``cfg.layer_groups()``."""
    if cfg.family == "encdec":
        return (((LayerSpec(XATTN, "mlp"),), cfg.n_layers),)
    if cfg.moe:
        out = []
        if cfg.first_dense_layers:
            out.append(((LayerSpec(ATTN, "dense_mlp"),),
                        cfg.first_dense_layers))
        out.append(((LayerSpec(ATTN, "moe"),),
                    cfg.n_layers - cfg.first_dense_layers))
        return tuple(out)
    ffn = "none" if cfg.d_ff == 0 else "mlp"
    return tuple((tuple(LayerSpec(k, ffn) for k in pattern), reps)
                 for pattern, reps in cfg.layer_groups())


def build_specs(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """One spec per layer, in stack order."""
    return tuple(spec for pattern, reps in model_groups(cfg)
                 for _ in range(reps) for spec in pattern)


def repeat_ends(cfg: ModelConfig) -> Tuple[bool, ...]:
    """Per layer, whether it ends a repeat of its group's pattern: where
    the reference's scanned step returns, and anchors its carry."""
    return tuple(j == len(pattern) - 1 for pattern, reps in model_groups(cfg)
                 for _ in range(reps) for j in range(len(pattern)))


#: what the reference's LM defines, and so what the port's runs
FAMILIES = ("dense", "hybrid", "moe", "encdec", "vlm", "ssm")
POS_KINDS = ("rope", "none", "sincos")
KINDS = (ATTN, LOCAL_ATTN, RGLRU, MLSTM, SLSTM)


def _check_supported(cfg: ModelConfig) -> None:
    why = None
    if cfg.family not in FAMILIES:
        why = f"the {cfg.family} family"
    elif cfg.pos_kind not in POS_KINDS:
        why = f"{cfg.pos_kind} positions"
    else:
        bad = sorted(set(cfg.pattern) - set(KINDS))
        if bad:
            why = f"layer kinds {bad}"
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {why} is not defined by the reference; the LM "
            f"runs the families {FAMILIES}, positions {POS_KINDS} and "
            f"layer kinds {KINDS}")


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """Apply ``fn`` to every tensor of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor of a nest of dicts and lists."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)
    else:
        yield tree


# ==========================================================================
# per-layer init / forward / decode
# ==========================================================================
def _init_layer(init: L.Init, spec: LayerSpec, cfg: ModelConfig) -> Params:
    p: Params = {"ln1": L.init_norm(init, cfg.d_model, cfg)}
    if spec.kind in (ATTN, LOCAL_ATTN):
        p["attn"] = A.init_attention(init, cfg)
    elif spec.kind == XATTN:
        p["attn"] = A.init_attention(init, cfg)
        p["ln_x"] = L.init_norm(init, cfg.d_model, cfg)
        p["cross"] = A.init_attention(init, cfg, cross=True)
    elif spec.kind == RGLRU:
        p["rglru"] = R.init_rglru_block(init, cfg)
    elif spec.kind == MLSTM:
        p["mlstm"] = R.init_mlstm_block(init, cfg)
    elif spec.kind == SLSTM:
        p["slstm"] = R.init_slstm_block(init, cfg)
    else:
        raise ValueError(spec.kind)
    if spec.ffn != "none" and not cfg.parallel_block:
        p["ln2"] = L.init_norm(init, cfg.d_model, cfg)
    if spec.ffn == "mlp":
        p["ffn"] = L.init_mlp(init, cfg.d_model, cfg.d_ff, cfg)
    elif spec.ffn == "dense_mlp":
        p["ffn"] = L.init_mlp(init, cfg.d_model, cfg.dense_d_ff or cfg.d_ff,
                              cfg)
    elif spec.ffn == "moe":
        p["ffn"] = M.init_moe(init, cfg)
    return p


def _ffn_apply(spec: LayerSpec, p: Params, x, cfg
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN -> (y, its MoE aux loss, float32; 0 for an MLP)."""
    if spec.ffn == "moe":
        return M.moe_forward(p["ffn"], x, cfg)
    return (L.mlp(p["ffn"], x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _layer_fwd(spec: LayerSpec, p: Params, x, positions, cfg,
               enc=None, collect_cache: bool = False, cache_len: int = 0):
    """Returns (x, the layer's MoE aux loss, its decode-cache entry: {}
    unless ``collect_cache``).  ``enc``: the encoder output an ``XATTN``
    layer cross-attends to.  A sharded x: the layer on each rank's batch
    shard, the aux loss the batch mean; with its sequence sharded too,
    ``_layer_fwd_seq``."""
    if seq_shards(x) > 1:
        return _layer_fwd_seq(spec, p, x, positions, cfg, enc=enc,
                              collect_cache=collect_cache,
                              cache_len=cache_len)
    if is_dtensor(x):
        names = _cache_names(spec, cfg) if collect_cache else []

        def local(a, pl):
            y, aux, entry = _layer_fwd(spec, pl, a[0], positions, cfg,
                                       enc=a[1] if len(a) > 1 else None,
                                       collect_cache=collect_cache,
                                       cache_len=cache_len)
            return (y, aux, *(entry[n] for n in names))
        y, aux, *vals = on_batch_shards(
            local, (x,) if enc is None else (x, enc), p,
            ["batch", "mean"] + ["batch"] * len(names))
        return y, aux, dict(zip(names, vals))
    eps = cfg.norm_eps
    h = L.apply_norm(p["ln1"], x, eps)
    entry: Params = {}
    if spec.kind in (ATTN, LOCAL_ATTN, XATTN):
        window = cfg.window if spec.kind == LOCAL_ATTN else 0
        with span("attn"):
            if collect_cache:
                att, kv = A.attn_forward(p["attn"], h, positions, cfg,
                                         window=window, return_kv=True)
                entry = _pad_kv(kv, cache_len, window, cfg)
            else:
                att = A.attn_forward(p["attn"], h, positions, cfg,
                                     window=window)
        if cfg.parallel_block:                 # cohere: one norm, parallel
            ff, aux = _ffn_apply(spec, p, h, cfg)
            return x + att + ff, aux, entry
        x = x + att
        if spec.kind == XATTN:
            hx = L.apply_norm(p["ln_x"], x, eps)
            with span("attn"):
                if collect_cache:
                    xa, ckv = A.attn_forward(p["cross"], hx, positions, cfg,
                                             kv_source=enc, return_kv=True)
                    entry["ck"], entry["cv"] = ckv["k"], ckv["v"]
                else:
                    xa = A.attn_forward(p["cross"], hx, positions, cfg,
                                        kv_source=enc)
            x = x + xa
    else:
        name = spec.kind                    # rglru | mlstm | slstm
        fwd = getattr(R, f"{name}_forward")
        if collect_cache:
            y, entry = fwd(p[name], h, cfg, return_cache=True)
        else:
            y = fwd(p[name], h, cfg)
        x = x + y
        if name != RGLRU:                   # xLSTM blocks: no FFN after
            return (x, torch.zeros((), dtype=torch.float32, device=x.device),
                    entry)
    if spec.ffn == "none":
        return x, torch.zeros((), dtype=torch.float32, device=x.device), entry
    ff, aux = _ffn_apply(spec, p, L.apply_norm(p["ln2"], x, eps), cfg)
    return x + ff, aux, entry


def _has_ffn(spec: LayerSpec, cfg) -> bool:
    """Whether the layer ends in its own FFN half, norm and residual (a
    parallel block's FFN runs beside attention; xLSTM blocks have none
    after them)."""
    return (spec.ffn != "none" and not cfg.parallel_block
            and spec.kind not in (MLSTM, SLSTM))


def _sub(p: Params, *names) -> Params:
    """The entries of a layer's parameters that a region uses (only
    those are gathered into it)."""
    return {n: p[n] for n in names if n in p}


def _back_to(y, x):
    """A region's output with its sequence gathered, returned to x's
    (batch, sequence) shards (each rank keeps its rows)."""
    return y.redistribute(x.device_mesh, seq_placements(x))


def _layer_fwd_seq(spec: LayerSpec, p: Params, x, positions, cfg, enc=None,
                   collect_cache: bool = False, cache_len: int = 0,
                   causal: bool = True):
    """``_layer_fwd`` of a DTensor x whose sequence is sharded
    (``_dtensor.seq_shards``), on each rank's (batch, sequence) shard,
    x's placements kept.  An attention layer: the norm and the q/k/v
    projections on the shard, RoPE at its positions; k and v (an MLA
    prefill's latent too, an ``XATTN`` layer's ``enc``) gathered along
    the sequence, whose backward reduce-scatters their gradients; the
    shard's queries over them (``q_offset`` its first position), the
    output projection, the residual, cross-attention, and a dense FFN
    half, on the shard.  A recurrent mixer, and an MoE FFN half, run on
    the gathered sequence (their regions on the batch shards) and return
    to the shards.  The cache entry keeps its sequence gathered, as the
    batch region's; the aux loss is the batch mean (0 without MoE)."""
    eps = cfg.norm_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    entry: Params = {}
    ffn_done = not _has_ffn(spec, cfg)
    if spec.kind in (ATTN, LOCAL_ATTN, XATTN):
        window = cfg.window if spec.kind == LOCAL_ATTN else 0
        latent = collect_cache and cfg.mla
        proj = {n: w for n, w in p["attn"].items() if n != "wo"}

        def project(a, _, pl, off):
            h = L.apply_norm(pl["ln1"], a[0], eps)
            q, k, v, lat = A.qkv(pl["attn"], h,
                                 positions[off:off + h.shape[1]], cfg)
            return (q, k, v, *(lat.values() if latent else ()))
        q, *kv = on_seq_shards(project, (x,), (), {"ln1": p["ln1"],
                                                   "attn": proj},
                               ["seq"] * (5 if latent else 3))
        gathered = [t.redistribute(t.device_mesh, batch_placements(t))
                    for t in kv]
        if spec.kind == XATTN:
            gathered.append(enc.redistribute(enc.device_mesh,
                                             batch_placements(enc)))
        ffn_here = not ffn_done and spec.ffn != "moe"
        ffn_done = ffn_done or ffn_here
        if cfg.parallel_block and spec.ffn == "moe":
            raise NotImplementedError("a parallel block's MoE FFN")
        names = (["ckv", "kr"] if cfg.mla else ["k", "v"]) \
            if collect_cache else []
        if collect_cache and spec.kind == XATTN:
            names += ["ck", "cv"]

        def finish(a, g, pl, off):
            xl, ql = a
            att = A.attend(pl["attn"], ql, g[0], g[1], cfg, causal=causal,
                           window=window, q_offset=off)
            if cfg.parallel_block:
                ff, _ = _ffn_apply(spec, pl, L.apply_norm(pl["ln1"], xl, eps),
                                   cfg)
                y = xl + att + ff
            else:
                y = xl + att
            out = {}
            if collect_cache:
                out = _pad_kv(dict(zip(names[:2], g[2:4] if latent
                                       else g[:2])), cache_len, window, cfg)
            if spec.kind == XATTN:
                hx = L.apply_norm(pl["ln_x"], y, eps)
                xa, ckv = A.attn_forward(pl["cross"], hx, positions, cfg,
                                         kv_source=g[-1], return_kv=True)
                y = y + xa
                out.update(ck=ckv["k"], cv=ckv["v"])
            if ffn_here:
                ff, _ = _ffn_apply(spec, pl, L.apply_norm(pl["ln2"], y, eps),
                                   cfg)
                y = y + ff
            return (y, *(out[n] for n in names))
        pf = _sub(p, "ln_x", "cross", "ln2", "ffn") if not cfg.parallel_block \
            else _sub(p, "ln1", "ffn")
        pf["attn"] = {"wo": p["attn"]["wo"]}
        y, *vals = on_seq_shards(finish, (x, q), gathered, pf,
                                 ["seq"] + ["batch"] * len(names))
        entry = dict(zip(names, vals))
    else:
        names = _cache_names(spec, cfg) if collect_cache else []
        mixer = _sub(p, "ln1", spec.kind)

        def local(a, pl):
            h = L.apply_norm(pl["ln1"], a[0], eps)
            fwd = getattr(R, f"{spec.kind}_forward")
            if collect_cache:
                yl, e = fwd(pl[spec.kind], h, cfg, return_cache=True)
            else:
                yl, e = fwd(pl[spec.kind], h, cfg), {}
            return (a[0] + yl, *(e[n] for n in names))
        y, *vals = on_batch_shards(local, (x,), mixer,
                                   ["batch"] * (1 + len(names)))
        y = _back_to(y, x)
        entry = dict(zip(names, vals))
    if not ffn_done:
        if spec.ffn == "moe":
            def moe(a, pl):
                ff, a_ = _ffn_apply(spec, pl,
                                    L.apply_norm(pl["ln2"], a[0], eps), cfg)
                return a[0] + ff, a_
            y, aux = on_batch_shards(moe, (y,), _sub(p, "ln2", "ffn"),
                                     ["batch", "mean"])
            y = _back_to(y, x)
        else:
            def dense(a, _, pl, off):
                ff, _ = _ffn_apply(spec, pl,
                                   L.apply_norm(pl["ln2"], a[0], eps), cfg)
                return a[0] + ff
            y = on_seq_shards(dense, (y,), (), _sub(p, "ln2", "ffn"),
                              ["seq"])
    return y, aux, entry


#: the matrix products whose outputs remat "dots" keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class _Remat(torch.autograd.Function):
    """Rematerialization that composes with ``torch.func`` (the
    population's ``vmap(grad(...))``, where ``torch.utils.checkpoint``'s
    saved-tensor hooks are refused): the forward runs ``run`` without a
    graph and keeps only its inputs; the backward runs it again under
    ``torch.func.vjp`` and applies the vjp, outside the enclosing graph
    (``torch.func.grad`` records its backward for a second derivative:
    recorded, every layer's recomputed activations would live to the
    end of the backward, as at remat "none").  ``run`` takes and returns
    tensors (a tuple out); the integer ones take no gradient.  The vmap
    rule is generated, so a kernel's Function inside ``run`` still sees
    the trial axis and folds it into its batch: one launch for all
    trials, forward and recompute."""
    generate_vmap_rule = True

    @staticmethod
    def forward(run, *args):
        with torch.no_grad():
            return run(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        args = ctx.saved_tensors
        diff = [i for i, a in enumerate(args) if a.is_floating_point()]

        def of_diff(*d):
            full = list(args)
            for i, t in zip(diff, d):
                full[i] = t
            return ctx.run(*full)
        with torch.no_grad():
            _, vjp = torch.func.vjp(of_diff, *(args[i] for i in diff))
            got = iter(vjp(grads))
        return (None, *(next(got) if a.is_floating_point() else None
                         for a in args))


def _functional_remat(fn):
    """``fn`` of any nest of arguments (tensors among them) returning a
    tensor or a tuple of tensors, rematerialized through ``_Remat``."""
    def wrapped(*args):
        leaves, tree = torch.utils._pytree.tree_flatten(args)
        where = [i for i, a in enumerate(leaves)
                 if isinstance(a, torch.Tensor)]

        def run(*ts):
            full = list(leaves)
            for i, t in zip(where, ts):
                full[i] = t
            out = fn(*torch.utils._pytree.tree_unflatten(full, tree))
            return out if isinstance(out, tuple) else (out,)
        out = _Remat.apply(run, *(leaves[i] for i in where))
        return out if len(out) > 1 else out[0]
    return wrapped


def _in_functorch() -> bool:
    """Whether a ``torch.func`` transform (vmap, grad) is running."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def _pad_kv(kv: Params, cache_len: int, window: int, cfg) -> Params:
    """Fit prefill K/V into the fixed cache buffer (ring-layout for local:
    the last ``buf_len`` entries, the one of position p at slot
    p % buf_len).  Entries are (B,S,...) of any rank (MLA's are 3-D):
    only axis 1 is padded."""
    out = {}
    S = next(iter(kv.values())).shape[1]
    buf_len = min(cache_len, window) if window else cache_len

    def pad_seq(v, n):
        return F.pad(v, (0, 0) * (v.dim() - 2) + (0, n))

    if not window and S > cache_len:
        raise ValueError(f"a prefill of {S} positions does not fit a cache "
                         f"of {cache_len}")
    for name, v in kv.items():
        if window:
            tail = v[:, -buf_len:] if S >= buf_len else v
            keep = tail.shape[1]
            start = (S - keep) % buf_len
            out[name] = torch.roll(pad_seq(tail, buf_len - keep), start,
                                   dims=1).to(cfg.compute_dtype)
        else:
            out[name] = pad_seq(v, cache_len - S).to(cfg.compute_dtype)
    return out


def _layer_decode(spec: LayerSpec, p: Params, x, cache: Params, pos, cfg):
    """x: (B,1,d); returns (x, new_cache_entry).  A sharded x: the step
    on each rank's batch shard, the cache gathered along any other dim
    for it (the new row written at its slot) and the updated entry put
    back on the cache's placements; a self-attention cache sharded on
    its slots stays so (``_layer_decode_chunks``)."""
    if is_dtensor(x) and spec.kind in (ATTN, LOCAL_ATTN, XATTN):
        dims = cache_chunk_dims(cache["ckv" if cfg.mla else "k"])
        if dims:
            return _layer_decode_chunks(spec, p, x, cache, pos, cfg, dims)
    if is_dtensor(x):
        names = list(cache)

        def local(a, pl):
            y, new = _layer_decode(spec, pl, a[0], dict(zip(names, a[1])),
                                   a[2], cfg)
            return (y, *(new[n] for n in names))
        y, *vals = on_batch_shards(
            local, (x, [cache[n] for n in names], pos), p,
            ["batch"] * (1 + len(names)))
        return y, {n: v.redistribute(v.device_mesh, cache[n].placements)
                   for n, v in zip(names, vals)}
    eps = cfg.norm_eps
    h = L.apply_norm(p["ln1"], x, eps)
    if spec.kind in (ATTN, LOCAL_ATTN, XATTN):
        window = cfg.window if spec.kind == LOCAL_ATTN else 0
        self_cache = {n: t for n, t in cache.items() if n not in ("ck", "cv")}
        att, new = A.attn_decode(p["attn"], h, self_cache, pos, cfg,
                                 window=window)
        if cfg.parallel_block:
            ff, _ = _ffn_apply(spec, p, h, cfg)
            return x + att + ff, new
        x = x + att
        if spec.kind == XATTN:
            hx = L.apply_norm(p["ln_x"], x, eps)
            x = x + A.cross_decode(p["cross"], hx, cache["ck"], cache["cv"],
                                   cfg)
            new = dict(new, ck=cache["ck"], cv=cache["cv"])
    else:
        y, new = getattr(R, f"{spec.kind}_decode")(p[spec.kind], h, cache,
                                                   cfg)
        x = x + y
        if spec.kind != RGLRU:              # xLSTM blocks: no FFN after
            return x, new
    if spec.ffn != "none":
        ff, _ = _ffn_apply(spec, p, L.apply_norm(p["ln2"], x, eps), cfg)
        x = x + ff
    return x, new


def _layer_decode_chunks(spec: LayerSpec, p: Params, x, cache: Params, pos,
                         cfg, dims):
    """``_layer_decode`` of a sharded x whose self-attention cache is
    sharded on its slots over mesh dims ``dims``, in three regions: the
    norm and the new token's projections on each rank's batch shard
    (``attention.decode_rows``); the queries and rows gathered along
    ``dims`` (one token a sequence) and attended over each rank's chunk
    of the cache, left where it is, the row written by the rank that
    owns its slot and the chunks combined across ``dims``
    (``attention.decode_cache``, ``_dtensor.chunk_combine``); the output
    projection, cross-attention (its ``ck`` / ``cv`` gathered as the
    batch region does) and the FFN on the batch shards again.  The
    updated entry goes back on the cache's placements."""
    from torch.distributed.tensor import Replicate
    eps = cfg.norm_eps
    window = cfg.window if spec.kind == LOCAL_ATTN else 0
    own = [n for n in cache if n not in ("ck", "cv")]
    mesh = x.device_mesh
    proj = {n: w for n, w in p["attn"].items() if n not in ("wo", "w_uv")}

    def rows(a, pl):
        q, r = A.decode_rows(pl["attn"], L.apply_norm(pl["ln1"], a[0], eps),
                             a[1], cfg)
        return (*q, *(r[n] for n in own))
    nq = 2 if cfg.mla else 1            # MLA's (q_lat, q_rope), else (q,)
    flat = on_batch_shards(rows, (x, pos), {"ln1": p["ln1"], "attn": proj},
                           ["batch"] * (nq + len(own)))
    rp = tuple(Replicate() if i in dims else b
               for i, b in enumerate(batch_placements(x)))
    flat = [t.redistribute(mesh, rp) for t in (*flat, pos)]
    combine = _dtensor.chunk_combine(mesh, dims)
    total = cache[own[0]].shape[1]

    def attend(a, chunks, _, off):
        out, new = A.decode_cache(
            a[:nq], dict(zip(own, a[nq:-1])), dict(zip(own, chunks)), a[-1],
            cfg, window=window, chunk=A.Chunk(off, total, combine))
        return (out.to(a[0].dtype), *(new[n] for n in own))
    out, *vals = on_cache_chunks(attend, flat, [cache[n] for n in own], dims,
                                 {}, ["batch"] + ["chunk"] * len(own))
    out = out.redistribute(mesh, batch_placements(x))

    def finish(a, pl):
        xl, outl = a[0], a[1]
        att = A.decode_out(pl["attn"], outl, cfg)
        if cfg.parallel_block:
            ff, _ = _ffn_apply(spec, pl, L.apply_norm(pl["ln1"], xl, eps), cfg)
            return xl + att + ff
        xl = xl + att
        if spec.kind == XATTN:
            hx = L.apply_norm(pl["ln_x"], xl, eps)
            xl = xl + A.cross_decode(pl["cross"], hx, a[2], a[3], cfg)
        if spec.ffn != "none":
            ff, _ = _ffn_apply(spec, pl, L.apply_norm(pl["ln2"], xl, eps), cfg)
            xl = xl + ff
        return xl
    pf = _sub(p, "ln1", "ln_x", "cross", "ln2", "ffn")
    pf["attn"] = _sub(p["attn"], "wo", "w_uv")
    y = on_batch_shards(finish, (x, out, *(cache[n] for n in ("ck", "cv")
                                          if n in cache)), pf, ["batch"])
    new = {n: v.redistribute(mesh, cache[n].placements)
           for n, v in zip(own, vals)}
    return y, {n: new.get(n, cache[n]) for n in cache}


def _init_cache_entry(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      cache_len: int, device, enc_len: int = 0) -> Params:
    if spec.kind in (ATTN, XATTN):
        e = A.init_cache_attn(cfg, batch, cache_len, device=device)
        if spec.kind == XATTN:
            e["ck"] = torch.zeros((batch, enc_len, cfg.n_kv_heads, cfg.hd),
                                  dtype=cfg.compute_dtype, device=device)
            e["cv"] = torch.zeros_like(e["ck"])
        return e
    if spec.kind == LOCAL_ATTN:
        return A.init_cache_attn(cfg, batch, cache_len, window=cfg.window,
                                 device=device)
    return getattr(R, f"init_{spec.kind}_cache")(cfg, batch, device=device)


def _cache_names(spec: LayerSpec, cfg: ModelConfig) -> List[str]:
    """The names of a layer's decode-cache entry."""
    return list(_init_cache_entry(spec, cfg, 0, 0, torch.device("meta")))


#: an encoder layer: non-causal self-attention and an MLP
ENCODER_SPEC = LayerSpec(ATTN, "mlp")


def _encoder_layer(p: Params, x, positions, cfg):
    if seq_shards(x) > 1:                   # on each (batch, seq) shard
        return _layer_fwd_seq(ENCODER_SPEC, p, x, positions, cfg,
                              causal=False)[0]
    if is_dtensor(x):                       # on each rank's batch shard
        return on_batch_shards(
            lambda xl, pl: _encoder_layer(pl, xl, positions, cfg), x, p,
            ["batch"])
    h = L.apply_norm(p["ln1"], x, cfg.norm_eps)
    with span("attn"):
        att = A.attn_forward(p["attn"], h, positions, cfg, causal=False)
    x = x + att
    ff, _ = _ffn_apply(ENCODER_SPEC, p, L.apply_norm(p["ln2"], x,
                                                     cfg.norm_eps), cfg)
    return x + ff


# ==========================================================================
# sinusoidal positions (whisper)
# ==========================================================================
def _sincos(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """Sinusoidal embeddings (..., d) of integer ``positions``: sines of
    the first d/2 columns, cosines of the rest, frequencies 10000^(-i /
    (d/2 - 1)) (the reference's denominator)."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ==========================================================================
# the model
# ==========================================================================
def cross_entropy(logits, labels) -> torch.Tensor:
    """``layers.cross_entropy``; of DTensor logits, on each rank's rows
    (on the DTensor itself, the gather's backward would build the global
    logits' gradient on every rank)."""
    if not is_dtensor(logits):
        return L.cross_entropy(logits, labels)
    nll, n = on_row_sums(lambda rows, _: L.cross_entropy_sums(*rows),
                         (logits, labels), 2)
    return nll / torch.clamp(n, min=1)


class LM:
    def __init__(self, cfg: ModelConfig):
        _check_supported(cfg)
        self.cfg = cfg
        self.specs = build_specs(cfg)
        self.ends = repeat_ends(cfg)

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device: DeviceLike = None,
             dtype=None) -> Params:
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (the CUDA card by default), stored in
        ``dtype`` (the config's storage dtype by default).  The
        distributions are the reference's; the numbers are not (JAX and
        torch generators differ)."""
        cfg = self.cfg
        init = L.Init(seed, resolve(device), dtype or cfg.store_dtype)
        params: Params = {
            "embed": L.init_embedding(init, cfg.vocab_size, cfg.d_model, cfg),
            "final_norm": L.init_norm(init, cfg.d_model, cfg),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = L.init_embedding(init, cfg.vocab_size,
                                                 cfg.d_model, cfg)
        params["layers"] = [_init_layer(init, spec, cfg)
                            for spec in self.specs]
        if cfg.family == "encdec":
            params["encoder"] = {
                "layers": [_init_layer(init, ENCODER_SPEC, cfg)
                           for _ in range(cfg.encoder_layers)],
                "norm": L.init_norm(init, cfg.d_model, cfg)}
        return params

    # ------------------------------------------------------------ helpers
    def _maybe_remat(self, fn):
        mode = self.cfg.remat
        if mode not in ("none", "dots", "full"):
            raise ValueError(f"remat {mode!r} is not none, dots or full")
        if mode == "none":
            return fn
        if _in_functorch():
            return _functional_remat(fn)
        if mode == "dots":
            ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_dots)
            return functools.partial(checkpoint, fn, use_reentrant=False,
                                     context_fn=ctx_fn)
        return functools.partial(checkpoint, fn, use_reentrant=False)

    def _embed_in(self, params, tokens):
        """Sharded tokens: on each rank's rows, the table gathered."""
        cfg = self.cfg

        def local(t, p):
            x = L.embed(p, t, cfg.compute_dtype)
            if cfg.scale_embed:
                # in the compute dtype, as the reference's weakly typed
                # scalar
                x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
            return x
        if is_dtensor(tokens):
            return constrain(on_row_shards(local, tokens, params["embed"],
                                           gather_last=False))
        return local(tokens, params["embed"])

    def _unembed(self, params, x, table=None):
        """The final norm and the logits; a sharded x on each rank's rows,
        the norm and the table gathered."""
        cfg = self.cfg
        if table is None:
            table = params["embed" if cfg.tie_embeddings else "unembed"]

        def local(xl, p):
            xl = L.apply_norm(p[0], xl, cfg.norm_eps)
            return L.unembed(p[1], xl, softcap=cfg.logit_softcap)
        if is_dtensor(x):
            return constrain(on_row_shards(
                local, x, (params["final_norm"], table)))
        return local(x, (params["final_norm"], table))

    def _prefixed(self, x, batch) -> Tuple[torch.Tensor, int]:
        """x (B,S,d) with a VLM batch's ``img_embeds`` (B,n_img,d), cast to
        the compute dtype, in front -> (x, n_img); (x, 0) otherwise."""
        if self.cfg.family != "vlm":
            return x, 0
        img = batch["img_embeds"].to(self.cfg.compute_dtype)
        return torch.cat([img, x], dim=1), img.shape[1]

    def _positions_in(self, x):
        """arange(S) for x (B,S,d), and x with sinusoidal positions added
        when the config has them."""
        positions = torch.arange(x.shape[1], device=x.device)
        if self.cfg.pos_kind == "sincos":
            x = x + _sincos(positions, self.cfg.d_model, x.dtype)
        return x, positions

    def encode(self, params, frames, *, train: bool = False):
        """The encoder over precomputed (stub) frame embeddings (B,S,d):
        sinusoidal positions added, ``encoder_layers`` non-causal
        attention + MLP layers (rematerialized as ``cfg.remat`` says when
        ``train``), a final norm."""
        cfg = self.cfg
        enc = params["encoder"]
        x = frames.to(cfg.compute_dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x = x + _sincos(positions, cfg.d_model, cfg.compute_dtype)

        def layer(lp, x, positions, cfg):
            with span("model.layer"):
                return _encoder_layer(lp, x, positions, cfg)
        step = self._maybe_remat(layer) if train else layer
        for lp in enc["layers"]:
            bw = backward_span("model.layer.backward", x)
            x = bw.output(step(lp, bw.input(x), positions, cfg))
        return L.apply_norm(enc["norm"], x, cfg.norm_eps)

    def _encoded(self, params, batch, train: bool = False):
        """The encoder output for an encoder-decoder batch, else None."""
        if self.cfg.family != "encdec":
            return None
        return self.encode(params, batch["frames"], train=train)

    # ------------------------------------------------------------ training
    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: {"tokens": (B,S)} (and "frames" (B,S_enc,d) for an
        encoder-decoder, "img_embeds" (B,n_img,d) for a VLM) -> (logits
        (B,S,V) of the text positions in the compute dtype, the MoE aux
        loss summed over layers: 0 without MoE)."""
        x, aux, table = self._trunk(params, batch)
        with span("model.head"):
            return self._unembed(params, x, table), aux

    def _trunk(self, params, batch):
        """``forward`` up to the head -> (the last layer's output at the
        text positions, the aux loss, the unembedding's table: None
        unless a tied float32 table was cast once for both uses)."""
        cfg = self.cfg
        out_table = None
        table = params["embed"]["table"]
        if cfg.tie_embeddings and table.dtype != cfg.compute_dtype:
            # one compute-dtype copy of a float32 tied table (the
            # population's) for both its uses, their gradients summed in
            # float32 as the reference's two casts sum them (_TiedCast)
            emb, out = _TiedCast.apply(table, cfg.compute_dtype)
            params = dict(params, embed={"table": emb})
            out_table = {"table": out}
        x = self._embed_in(params, batch["tokens"])
        enc = self._encoded(params, batch, train=True)
        x, n_prefix = self._prefixed(x, batch)
        x, positions = self._positions_in(x)
        if n_prefix:
            x = constrain(x)

        def layer(spec, lp, x, positions, enc):
            with span("model.layer"):
                return _layer_fwd(spec, lp, x, positions, self.cfg,
                                  enc=enc)[:2]

        step = self._maybe_remat(layer)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec, lp, end in zip(self.specs, params["layers"], self.ends):
            bw = backward_span("model.layer.backward", x)
            x, a = step(spec, lp, bw.input(x), positions, enc)
            x = bw.output(x)
            aux = aux + a
            if end:
                x = constrain(x)
        return x[:, n_prefix:], aux, out_table

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """batch: {"tokens", "labels"} (B,S) -> (mean cross entropy plus
        the weighted aux loss, {"ce", "aux", "tokens"})."""
        x, aux, table = self._trunk(params, batch)
        with span("model.head"):
            bw = backward_span("model.head.backward", x)
            logits = self._unembed(params, bw.input(x), table)
            ce = bw.output(cross_entropy(logits, batch["labels"]))
        total = ce + self.cfg.router_aux_weight * aux
        return total, {"ce": ce, "aux": aux,
                       "tokens": (batch["labels"] >= 0).sum()}

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int,
                   device: DeviceLike = None, enc_len: int = 0):
        """Zeroed decode caches on ``device`` (the CUDA card by default);
        an ``XATTN`` layer's holds ``enc_len`` encoder positions."""
        device = resolve(device)
        return {"layers": [_init_cache_entry(spec, self.cfg, batch,
                                             cache_len, device, enc_len)
                           for spec in self.specs],
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}

    def prefill(self, params, batch, cache_len: int):
        """Run the full prompt, build a decode cache sized ``cache_len``
        (a VLM's image prefix takes n_img of its positions).  batch:
        {"tokens": (B,S)} (and "frames" for an encoder-decoder,
        "img_embeds" for a VLM) -> (cache, logits of the last position
        (B,V))."""
        tokens = batch["tokens"]
        x = self._embed_in(params, tokens)
        enc = self._encoded(params, batch)
        x, n_prefix = self._prefixed(x, batch)
        x, positions = self._positions_in(x)
        if n_prefix:
            x = constrain(x)
        layers: List[Params] = []
        for spec, lp, end in zip(self.specs, params["layers"], self.ends):
            x, _, entry = _layer_fwd(spec, lp, x, positions, self.cfg,
                                     enc=enc, collect_cache=True,
                                     cache_len=cache_len)
            layers.append(entry)
            if end:
                x = constrain(x)
        logits = self._unembed(params, x[:, -1:])[:, 0]
        cache = {"layers": layers,
                 "pos": torch.full((tokens.shape[0],), x.shape[1],
                                   dtype=torch.int32, device=x.device)}
        return cache, logits

    def decode_step(self, params, cache, tokens):
        """tokens: (B,) -> (logits (B,V), new cache).  Attention layers
        write their new KV row into the cache's own tensors."""
        pos = cache["pos"]
        # the layers index the cache with one int64 copy of the (int32)
        # position, torch's index dtype, rather than each casting it
        at = pos.long()
        x = self._embed_in(params, tokens[:, None])
        if self.cfg.pos_kind == "sincos":
            x = x + _sincos(at[:, None], self.cfg.d_model, x.dtype)
        layers: List[Params] = []
        for spec, lp, lc, end in zip(self.specs, params["layers"],
                                     cache["layers"], self.ends):
            x, entry = _layer_decode(spec, lp, x, lc, at, self.cfg)
            layers.append(entry)
            if end:
                x = constrain(x)
        logits = self._unembed(params, x[:, 0])
        return logits, {"layers": layers, "pos": pos + 1}
