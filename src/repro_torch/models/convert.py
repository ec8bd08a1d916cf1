"""Carry the JAX package's LM weights into the port.

``params_from_reference(cfg, tree)`` takes the pytree the reference's
``LM(cfg).init`` returns, with its leaves as numpy arrays (or anything
``np.asarray`` reads), and returns the port's parameters: the same nested
dicts, with each layer group's leading ``repeats`` dim unstacked into the
port's flat list of layers.  Dense weights stay (d_in, d_out), the layout
the port's ``layers.dense`` applies as ``x @ w``, so no weight is
transposed.  An encoder-decoder's encoder layers, stacked by the
reference with a leading ``encoder_layers`` dim, become the list
``params["encoder"]["layers"]`` beside the encoder's ``norm``.  A layer's
nested blocks come across whole (an sLSTM's ``r`` (4, H, dh, dh), its
``ffn`` and ``ffn_norm`` inside ``slstm``; xlstm-125m's one group (m, m,
m, s) x 3 unstacks into 12 layers).  With it
the two packages compute the same function on the same weights, which is
how the tests hold one against the other.

``train_state_from_reference(cfg, state, device)`` carries a training
state across: the reference's ``{"params", "opt": {"m", "v", "step"}}``
(``launch/steps.init_train_state``) into the port's, each of params, m
and v unstacked as above; with ``population=True`` every leaf has a
leading population axis (``core/vmap_trials.py``'s stacked state), kept
in front of each unstacked layer's leaves.

``cnn_params_from_reference(tree, device)`` does the same for the §4 CNN
(``models/cnn.py``): its conv weights go from the reference's HWIO to
PyTorch's OIHW, its fully connected weights stay (in, out).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import model_groups, tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def unstack_groups(cfg: ModelConfig, groups: List[Dict[str, Any]],
                   population: bool = False) -> List:
    """The reference's per-group nests (``{str(j): leaves with a leading
    repeats dim}``, one per group of its ``build_groups``, which
    ``model_groups`` copies: an MoE stack's dense first layers are a group
    of their own) -> one nest per layer, in stack order.  Serves its
    parameters, training state and caches alike; with ``population`` the
    repeats dim is the second."""
    specs = model_groups(cfg)
    if len(groups) != len(specs):
        raise ValueError(f"{cfg.name}: {len(groups)} layer groups, the "
                         f"config has {len(specs)}")
    layers = []
    for (pattern, repeats), group in zip(specs, groups):
        for idx in _stacked(repeats, population):
            for j in range(len(pattern)):
                layers.append(tree_map(lambda a, i=idx: a[i], group[str(j)]))
    return layers


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device="cpu", population: bool = False
                          ) -> Dict[str, Any]:
    """The reference's ``LM.init`` pytree -> the port's parameters on
    ``device``, in the leaves' own dtype (a leading population axis
    kept when ``population``)."""
    conv = lambda a: _tensor(a, device)  # noqa: E731
    params = {name: tree_map(conv, sub) for name, sub in tree.items()
              if name not in ("groups", "encoder")}
    params["layers"] = [tree_map(conv, layer) for layer in
                        unstack_groups(cfg, tree["groups"], population)]
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": [tree_map(lambda a, i=i: conv(a[i]), enc["layers"])
                       for i in _stacked(cfg.encoder_layers, population)],
            "norm": tree_map(conv, enc["norm"])}
    return params


def _stacked(n: int, population: bool):
    """Indices of the n entries of a stacked dim: the first, or with
    ``population`` the second."""
    return [(slice(None), r) if population else r for r in range(n)]


def train_state_from_reference(cfg: ModelConfig, state: Dict[str, Any],
                               device="cpu", population: bool = False
                               ) -> Dict[str, Any]:
    """The reference's training state ``{"params", "opt": {"m", "v",
    "step"}}`` -> the port's, on ``device``: params, m and v as
    ``params_from_reference`` carries them, the step an int32 tensor
    ((P,) with ``population``)."""
    conv = lambda tree: params_from_reference(  # noqa: E731
        cfg, tree, device, population)
    opt = state["opt"]
    return {"params": conv(state["params"]),
            "opt": {"m": conv(opt["m"]), "v": conv(opt["v"]),
                    "step": _tensor(opt["step"], device).to(torch.int32)}}


def cnn_params_from_reference(tree: Dict[str, Any], device="cpu"
                              ) -> Dict[str, Any]:
    """The reference's ``init_cnn`` pytree -> the port's CNN parameters
    on ``device``: conv ``w`` HWIO -> OIHW, everything else as it is."""
    params = {}
    for name, layer in tree.items():
        w = np.asarray(layer["w"])
        if name.startswith("conv"):
            w = w.transpose(3, 2, 0, 1)
        params[name] = {"w": _tensor(np.ascontiguousarray(w), device),
                        "b": _tensor(layer["b"], device)}
    return params
