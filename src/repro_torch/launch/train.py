"""End-to-end training driver of the port.

Runs an architecture of the port (full or --reduced) with the
deterministic data pipeline, AdamW + warmup-cosine, microbatch gradient
accumulation, atomic async checkpoints and automatic --resume, as the
reference's ``launch/train.py`` does.  It runs on the CUDA card unless
given ``--device`` (``device="cpu"`` in the tests), and raises when there
is no card and no device.  The attention and RG-LRU layers go through
the hand-written CUDA kernels forward and backward there.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve
from repro_torch.launch import steps as S
from repro_torch.models.model import tensors, tree_map
from repro_torch.optim import AdamWConfig, adamw_update, linear_warmup_cosine


def make_accum_train_step(cfg, opt_cfg, schedule, accum: int):
    """Gradient accumulation over ``accum`` microbatches: their gradients
    summed in float32, averaged, one AdamW update."""
    model, base_step = S.make_train_step(cfg, opt_cfg, schedule)
    if accum <= 1:
        return model, base_step

    def train_step(state, batch):
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                 for k, v in batch.items()}
        gsum = tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                        state["params"])
        lsum = 0.0
        for i in range(accum):
            p_c = S.cast_params(state["params"], cfg.compute_dtype)
            loss, _, g = S.loss_and_grads(model, p_c,
                                          {k: v[i] for k, v in micro.items()})
            del p_c
            for acc, gi in zip(tensors(gsum), tensors(g)):
                acc.add_(gi)
            lsum = lsum + loss
        grads = tree_map(lambda a: a / accum, gsum)
        del gsum
        lr = schedule(state["opt"]["step"]) if schedule else opt_cfg.lr
        with torch.no_grad():
            new_p, new_opt, om = adamw_update(grads, state["opt"],
                                              state["params"], opt_cfg, lr)
        return ({"params": new_p, "opt": new_opt},
                {"loss": lsum / accum, "lr": lr, **om})

    return model, train_step


def _to_device(batch, device):
    return {k: torch.as_tensor(v, device=device).long()
            for k, v in batch.items()}


def train(arch: str, steps: int, batch: int, seq: int, *, reduced=True,
          lr=3e-4, warmup=20, accum=1, ckpt_dir: Optional[str] = None,
          ckpt_every=50, resume=False, seed=0, log_every=10, log=print,
          device=None) -> float:
    """Train for ``steps`` steps (from the latest checkpoint with
    ``resume``) -> the last step's loss.  Parameters come from a
    ``torch.Generator`` seeded with ``seed`` (not the reference's
    numbers); the batches are the reference pipeline's, bit for bit."""
    dev = resolve(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=lr)
    schedule = linear_warmup_cosine(lr, warmup, steps)
    _, step_fn = make_accum_train_step(cfg, opt_cfg, schedule, accum)

    state = S.init_train_state(cfg, seed, dev)
    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if resume and mgr and mgr.latest_step() is not None:
        state, meta = mgr.restore(state)
        start = int(meta["step"]) + 1
        log(f"[train] resumed from step {start - 1}")

    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed)).start_prefetch(from_step=start)
    last_loss = float("nan")
    done = start - 1        # the last step whose update is in ``state``
    torn = False            # a step stopped part way: its update writes
    t0 = time.time()        # ``state`` in place, so ``state`` is mixed
    try:
        for t in range(start, steps):
            _, np_batch = pipe.next_prefetched()
            torn = True
            state, metrics = step_fn(state, _to_device(np_batch, dev))
            torn = False
            done = t
            if t % log_every == 0 or t == steps - 1:
                last_loss = float(metrics["loss"])
                rate = (t - start + 1) / (time.time() - t0)
                log(f"[train] step={t} loss={last_loss:.4f} "
                    f"lr={float(metrics['lr']):.2e} "
                    f"gnorm={float(metrics['grad_norm']):.2f} "
                    f"({rate:.2f} it/s)")
                if not np.isfinite(last_loss):
                    raise FloatingPointError(f"loss diverged at step {t}")
            if mgr and ckpt_every and t and t % ckpt_every == 0:
                mgr.save(t, state)
    finally:
        pipe.stop_prefetch()
        if torn:
            log(f"[train] step {done + 1} failed part way; its state is "
                "not saved (the latest checkpoint stands)")
        elif mgr and done >= start:
            mgr.save(done, state)
        if mgr:
            mgr.wait()
    return last_loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    loss = train(args.arch, args.steps, args.batch, args.seq,
                 reduced=args.reduced, lr=args.lr, accum=args.accum, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, resume=args.resume,
                 seed=args.seed, device=args.device)
    print(f"final loss: {loss:.4f}")


if __name__ == "__main__":
    main()
