"""Small convolutional classifier — the paper's §4 alpha-test model
("a convolutional neural network with 3 convolutional layers and 2 fully
connected layers ... trained on the German traffic sign dataset").

The dataset is a seeded synthetic stand-in (43 classes of structured
32x32x3 patterns + noise), made with numpy exactly as the JAX package
makes it; the architecture matches the paper's description and is the
trial of the §4 HPO run (``chip_smoke.py``, ``examples/hpo_cnn.py`` in
the reference).

Layouts: images come in NHWC, as ``synthetic_signs`` makes them; the
convolutions run in PyTorch's NCHW with OIHW weights (3x3, stride 1,
padding 1 = the reference's SAME) and 2x2 max pooling; the features are
permuted back to NHWC before the flatten, so ``fc0``'s rows follow the
reference's (h, w, c) order.  Fully connected weights are (in, out),
applied as ``x @ w``.  ``models.convert.cnn_params_from_reference``
carries the reference's weights over.  The convolutions and products are
cuDNN and cuBLAS: the reference runs them as XLA, outside any Pallas
kernel.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve

N_CLASSES = 43
IMG = 32

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class CNNConfig:
    channels: Tuple[int, int, int] = (16, 32, 64)
    fc_width: int = 128
    n_classes: int = N_CLASSES


def init_cnn(seed: int, cfg: CNNConfig = CNNConfig(),
             device: DeviceLike = None) -> Params:
    """He-normal weights and zero biases, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``: the reference's distributions,
    not its numbers."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) * math.sqrt(
            2.0 / fan_in)

    params: Params = {}
    c0 = 3
    for i, c in enumerate(cfg.channels):
        params[f"conv{i}"] = {"w": normal((c, c0, 3, 3), 9 * c0),
                              "b": torch.zeros((c,), device=dev)}
        c0 = c
    flat = cfg.channels[-1] * (IMG // 8) * (IMG // 8)
    params["fc0"] = {"w": normal((flat, cfg.fc_width), flat),
                     "b": torch.zeros((cfg.fc_width,), device=dev)}
    params["fc1"] = {"w": normal((cfg.fc_width, cfg.n_classes),
                                 cfg.fc_width),
                     "b": torch.zeros((cfg.n_classes,), device=dev)}
    return params


def cnn_forward(params: Params, x: torch.Tensor,
                cfg: CNNConfig = CNNConfig()) -> torch.Tensor:
    """x: (B, 32, 32, 3) NHWC -> logits (B, n_classes)."""
    x = x.permute(0, 3, 1, 2)
    for i in range(len(cfg.channels)):
        p = params[f"conv{i}"]
        x = F.max_pool2d(F.relu(F.conv2d(x, p["w"], p["b"], padding=1)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc0"]["w"] + params["fc0"]["b"])
    return x @ params["fc1"]["w"] + params["fc1"]["b"]


def cnn_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: CNNConfig = CNNConfig()):
    """Mean cross-entropy and accuracy of one batch {"image", "label"}."""
    logits = cnn_forward(params, batch["image"], cfg)
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels)
    acc = (torch.argmax(logits, -1) == labels).float().mean()
    return loss, acc


@functools.lru_cache(maxsize=1)
def _prototypes() -> np.ndarray:
    """The 43 class prototypes: seeded (1234) normal images blurred along
    both axes, then renormalized so the class signal survives the
    additive noise.  The same for every call, so made once (read-only)."""
    proto_rng = np.random.default_rng(1234)
    protos = proto_rng.normal(0, 1, (N_CLASSES, IMG, IMG, 3)).astype(
        np.float32)
    for _ in range(3):
        protos = (protos + np.roll(protos, 1, 1) + np.roll(protos, 1, 2)) / 3
    protos /= protos.std(axis=(1, 2, 3), keepdims=True)
    protos.setflags(write=False)
    return protos


def synthetic_signs(seed: int, n: int) -> Dict[str, np.ndarray]:
    """Class-conditional structured patterns (learnable stand-in for GTSRB),
    equal bit for bit to the reference's."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLASSES, n)
    imgs = _prototypes()[labels] + rng.normal(
        0, 0.5, (n, IMG, IMG, 3)).astype(np.float32)
    return {"image": imgs.astype(np.float32), "label": labels.astype(
        np.int32)}


def _to(batch: Dict[str, np.ndarray], dev: torch.device):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_cnn(assignment: Dict, steps: int = 60, batch: int = 64,
              seed: int = 0, report=None, device: DeviceLike = None
              ) -> float:
    """Train with the given hyperparameters on ``device`` (the CUDA card
    by default), return validation accuracy — the §4 trial function.
    SGD with momentum, written out as the reference's update:
    ``vel = m·vel − lr·g; p = p + vel``."""
    dev = resolve(device)
    cfg = CNNConfig(fc_width=int(assignment.get("fc_width", 128)))
    lr = float(assignment.get("lr", 1e-3))
    momentum = float(assignment.get("momentum", 0.9))
    params = init_cnn(seed, cfg, device=dev)
    leaves = [p for layer in params.values() for p in layer.values()]
    for p in leaves:
        p.requires_grad_(True)
    vel = [torch.zeros_like(p) for p in leaves]

    def evaluate(data) -> float:
        with torch.no_grad():
            return float(cnn_loss(params, data, cfg)[1])

    val = _to(synthetic_signs(9999, 256), dev)
    for t in range(steps):
        data = _to(synthetic_signs(seed * 10_000 + t, batch), dev)
        loss = F.cross_entropy(cnn_forward(params, data["image"], cfg),
                               data["label"].long())
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            # one launch per operation over all ten tensors, each
            # element rounded as in the reference's update
            lr_g = torch._foreach_mul(grads, lr)
            torch._foreach_mul_(vel, momentum)
            torch._foreach_sub_(vel, lr_g)
            torch._foreach_add_(leaves, vel)
        if report is not None and t % 10 == 9:
            report(t, evaluate(val))
    return evaluate(val)
