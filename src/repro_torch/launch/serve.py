"""Batched serving driver: prefill a batch of prompts, then greedy-decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 32

Without ``--device`` it runs on the CUDA card and raises when there is
none.  The prefill's attention and RG-LRU layers go through the
hand-written CUDA kernels there (``kernels/ops.py``); decode is plain
torch, as the reference's is XLA, and so are the xLSTM blocks, for which
the reference has no kernel.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve
from repro_torch.launch import steps as S


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, batch: int, prompt_len: int, gen: int, *,
          reduced=True, seed=0, device=None, params=None, log=print):
    """Greedy-decode ``gen`` tokens after ``batch`` random prompts of
    ``prompt_len`` tokens -> (batch, gen) int64 numpy array.

    Prompts come from ``np.random.default_rng(seed)``, as in the
    reference, and from the same generator right after them a VLM's
    image embeddings (batch, ``n_img_tokens``, d) or an encoder-decoder's
    frames (batch, ``encoder_seq``, d).  ``params`` (e.g. from
    ``models.convert``) are cast to the compute dtype and moved to the
    device; without them the weights are drawn from a ``torch.Generator``
    seeded with ``seed`` on the device, each cast once to the compute
    dtype.

    The decode cache holds ``prompt_len + gen`` positions, and a VLM's
    image prefix besides: the reference's ``serve`` leaves the prefix
    out, so its cache overflows once the prefix is longer than ``gen``
    (ROADMAP.md §3)."""
    dev = resolve(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cache_len = prompt_len + gen
    if cfg.family == "vlm":
        cache_len += cfg.n_img_tokens
    model, prefill_step = S.make_prefill_step(cfg, cache_len)
    _, serve_step = S.make_serve_step(cfg)
    if params is None:
        params = model.init(seed=seed, device=dev, dtype=cfg.compute_dtype)
    else:
        params = S.cast_params(params, cfg.compute_dtype, device=dev)

    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)), device=dev)
    pbatch = {"tokens": prompts}
    if cfg.family == "vlm":
        pbatch["img_embeds"] = torch.as_tensor(
            rng.normal(0, 1, (batch, cfg.n_img_tokens, cfg.d_model)),
            dtype=cfg.compute_dtype, device=dev)
    elif cfg.family == "encdec":
        pbatch["frames"] = torch.as_tensor(
            rng.normal(0, 1, (batch, cfg.encoder_seq, cfg.d_model)),
            dtype=cfg.compute_dtype, device=dev)

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        cache, logits = prefill_step(params, pbatch)
        tok = torch.argmax(logits, dim=-1)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            tok, cache = serve_step(params, cache, tok)
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        seqs = torch.stack(out, dim=1).cpu().numpy()
    log(f"[serve] prefill {batch}x{prompt_len} in {t_prefill * 1e3:.1f}ms; "
        f"decoded {gen - 1} steps in {t_decode * 1e3:.1f}ms "
        f"({(gen - 1) * batch / max(t_decode, 1e-9):.1f} tok/s)")
    return seqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    seqs = serve(args.arch, args.batch, args.prompt_len, args.gen,
                 reduced=args.reduced, device=args.device)
    print(f"generated shape: {seqs.shape}")


if __name__ == "__main__":
    main()
