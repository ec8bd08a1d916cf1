"""Step functions of the port and their sharding specs for a given
(arch, shape, mesh) cell: the reference's ``launch/steps.py``.  Used by
the dry run, the trainer and the server.

A train step differentiates the compute-dtype cast of the float32
masters, as the reference does, and updates the masters with AdamW; it
donates the state it is given, as the reference's jit does
(``adamw_update`` writes the new values into its tensors).

The specs (``state_specs``, ``batch_specs``, ``decode_specs``) are trees
of ``auto_shard.Spec`` over the port's unstacked layers; ``named`` turns
them into DTensor placements on a ``DeviceMesh`` and
``auto_shard.shard_tree`` into distributed tensors.  A step given
DTensors runs sharded: the model runs each layer, and the embedding and
the unembedding, as one region of plain tensors on each rank's shards
with the region's weights gathered (FSDP-style, ``repro_torch._dtensor``),
the activation anchors (``distributed/act_sharding.py``) hold the
activations between regions to the ambient (batch, seq) spec, and
``grad_specs`` anchor each gradient to its parameter's placements, so a
gradient is reduce-scattered onto the shards its parameter keeps rather
than all-reduced whole.  Given plain tensors (no mesh) a step computes
exactly what it computes unsharded.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.registry import cache_specs
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed.auto_shard import (MIN_SHARD_ELEMS, Spec,
                                                _is_spec, _leaves, _map,
                                                auto_spec, batch_seq_spec,
                                                layer_repeats, placements,
                                                tree_specs)
from repro_torch.models import LM
from repro_torch.models.common import ModelConfig, ShapeSpec
from repro_torch.models.layers import cast_param
from repro_torch.models.model import tensors, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.spans import span


def cast_params(params, dtype: torch.dtype, device=None):
    """Cast floating leaves (f32 masters) to the compute dtype, once, and
    move every leaf to ``device`` when one is given: one ``cast`` span."""
    with span("cast"):
        return tree_map(
            lambda a: cast_param(
                a, dtype if a.is_floating_point() else a.dtype, device),
            params)


def cast_param_shapes(shapes, dtype: torch.dtype):
    """Meta-tensor mirror of ``cast_params`` (serving loads weights
    pre-cast; the dry run runs against compute-dtype parameters)."""
    return tree_map(
        lambda s: torch.empty(s.shape, device="meta",
                              dtype=dtype if s.is_floating_point()
                              else s.dtype), shapes)


def loss_and_grads(model: LM, params, batch):
    """``model.loss`` at ``params`` and its gradients by autograd ->
    (loss, metrics, grads): grads in ``params``' structure and dtypes,
    loss and metrics detached.  ``params`` are not changed (the gradient
    is taken at detached aliases of them)."""
    leaves = tree_map(lambda a: a.detach().requires_grad_(), params)
    with torch.enable_grad():
        with span("step.forward"):
            loss, metrics = model.loss(leaves, batch)
        grads = iter(torch.autograd.grad(loss, list(tensors(leaves))))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), leaves))


def anchor_grads(grads, grad_specs):
    """Each DTensor gradient redistributed to its spec's placements (a
    pending sum over the batch shards becomes a reduce-scatter onto the
    parameter's shards); plain tensors are returned as they are.  An
    entry against the mesh's order is taken in mesh order, as
    ``auto_shard.shard_tree(..., reorder=True)`` placed the parameter."""
    from torch.distributed.tensor import DTensor
    flat = iter(list(_leaves(grad_specs, _is_spec)))

    def one(g):
        spec = next(flat)
        if not isinstance(g, DTensor):
            return g
        target = tuple(placements(spec, g.device_mesh, reorder=True))
        if tuple(g.placements) == target:
            return g
        return g.redistribute(g.device_mesh, target)
    return tree_map(one, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, schedule=None,
                    grad_specs=None):
    """-> (model, train_step(state, batch) -> (state, metrics)).  batch:
    {"tokens", "labels"} (B,S) integers on the state's device.
    grad_specs: an optional spec tree matching the params; each gradient
    is anchored to its parameter's sharding (``anchor_grads``), so it is
    reduce-scattered onto the parameter's shards instead of all-reduced
    whole."""
    model = LM(cfg)

    def train_step(state, batch):
        with span("step"):
            # differentiate w.r.t. the cast params; AdamW re-accumulates
            # in f32
            p_c = cast_params(state["params"], cfg.compute_dtype)
            with span("step.grads"):
                loss, metrics, grads = loss_and_grads(model, p_c, batch)
            del p_c
            if grad_specs is not None:
                grads = anchor_grads(grads, grad_specs)
            lr = schedule(state["opt"]["step"]) if schedule else opt_cfg.lr
            with torch.no_grad(), span("optim.adamw"):
                new_p, new_opt, om = adamw_update(
                    grads, state["opt"], state["params"], opt_cfg, lr)
        metrics = dict(metrics, loss=loss, lr=lr, **om)
        return {"params": new_p, "opt": new_opt}, metrics

    return model, train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    model = LM(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len)

    return model, prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (params, cache, tokens) -> (next, cache)."""
    model = LM(cfg)

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        return torch.argmax(logits, dim=-1), cache

    return model, serve_step


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Parameters from ``seed`` in the config's storage dtype (float32
    masters) and zero AdamW state, on ``device`` (the card by default)."""
    params = LM(cfg).init(seed, resolve(device))
    return {"params": params, "opt": adamw_init(params)}


def train_state_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_train_state``'s tree as meta tensors: shapes and dtypes,
    no storage (the reference's ``jax.eval_shape`` of it)."""
    return init_train_state(cfg, 0, "meta")


# ==========================================================================
# sharding specs per cell
# ==========================================================================
def state_specs(cfg: ModelConfig, mesh, state_shapes, *,
                min_elems: int = MIN_SHARD_ELEMS) -> Dict[str, Any]:
    """Params + optimizer state: greedy auto-sharding, each layer judged
    as one of its group's stacked repeats (``tree_specs``); m and v on
    the parameters' specs, the step replicated."""
    p_specs = tree_specs(state_shapes["params"], mesh, cfg,
                         min_elems=min_elems)
    return {"params": p_specs,
            "opt": {"m": p_specs, "v": p_specs, "step": Spec()}}


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                specs: Dict[str, Any]) -> Dict[str, Spec]:
    """Activation input specs for train / prefill batches; ``specs`` as
    ``registry.input_specs`` gives them ({name: (shape, dtype)})."""
    out = {}
    for name, (dims, _) in specs.items():
        if name in ("tokens", "labels"):
            out[name] = batch_seq_spec(mesh, dims[0], dims[1])
        elif name in ("img_embeds", "frames"):
            out[name] = Spec(*batch_seq_spec(mesh, dims[0], dims[1]), None)
        else:
            raise KeyError(name)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, mesh
                 ) -> Tuple[Any, Any, Spec]:
    """(cache shapes, cache specs, token spec) for ``serve_step``: each
    layer's cache leaf judged as one of its group's stacked repeats
    (leading dim skipped), as the reference judges its stacked caches;
    ``pos`` and the tokens over whatever divides the batch."""
    cshapes = cache_specs(cfg, shape)
    cspecs = {"layers": [
        _map(lambda t, r=r: auto_spec(t.shape, mesh, skip_leading=True,
                                      repeats=r), entry,
             lambda x: isinstance(x, torch.Tensor))
        for entry, r in zip(cshapes["layers"], layer_repeats(cfg))]}
    cspecs["pos"] = batch_seq_spec(mesh, shape.global_batch, None)
    tok = batch_seq_spec(mesh, shape.global_batch, None)
    return cshapes, cspecs, tok


def named(mesh, spec_tree):
    """DTensor placements on ``mesh`` for every spec of a spec tree (the
    reference's ``NamedSharding`` tree)."""
    return _map(lambda s: tuple(placements(s, mesh)), spec_tree, _is_spec)
