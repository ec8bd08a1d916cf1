"""Hold this checkout's flash kernels at ``q_offset=0`` against another
checkout's, bit for bit, on the card.

The other checkout's ``csrc/flash_attention.cu`` (one whose C entry
points take no ``q_offset``) is compiled with this checkout's nvcc flags
into ``<other>/build/kernels`` and called through its own C entry points;
this checkout's kernels through their wrappers at ``q_offset=0``.  Each
case runs the forward (with its row log-sum-exp) and the backward on the
same inputs in both and compares every output with ``torch.equal``.

    python3 scripts/flash_offset0_parity.py --other build/parent

prints one JSON line a case (its shapes and whether each output is
equal) and exits non-zero unless every output is.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402

#: (name, B, Sq, Skv, H, K, D, causal, window, softcap, dtype): phase 4's
#: layouts of ``chip_smoke.py`` (the serve shape, granite's, a softcap,
#: ragged and non-causal ones) and llava's
CASES = (
    ("serve", 4, 3000, 3000, 10, 1, 256, True, 2048, 0.0, "bfloat16"),
    ("serve_f32", 1, 1000, 1000, 10, 1, 256, True, 512, 0.0, "float32"),
    ("granite", 1, 4096, 4096, 32, 8, 128, True, 0, 0.0, "bfloat16"),
    ("softcap", 2, 1024, 1024, 8, 2, 128, True, 0, 50.0, "bfloat16"),
    ("ragged", 2, 1000, 1500, 8, 2, 64, True, 300, 0.0, "float32"),
    ("ragged_bf16", 2, 1000, 1500, 8, 2, 64, True, 300, 0.0, "bfloat16"),
    ("noncausal_d16", 3, 777, 555, 4, 4, 16, False, 0, 0.0, "bfloat16"),
    ("llava", 4, 3328, 3328, 56, 8, 128, True, 0, 0.0, "bfloat16"),
)
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def other_library(other: pathlib.Path) -> ctypes.CDLL:
    """The other checkout's flash library, built with this one's flags."""
    src = other / "src" / "repro_torch" / "kernels" / "csrc" / \
        "flash_attention.cu"
    out = other / "build" / "kernels" / "libflash_attention-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists():
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.flash_attention_launch.argtypes = [P] * 5 + [I] * 9 + [F] * 2 + [P]
    lib.flash_attention_bwd_launch.argtypes = ([P] * 11 + [I] * 9 + [F] * 2
                                               + [P])
    return lib


def other_run(lib, q, k, v, do, causal, window, softcap, scale):
    """The other library's forward (o, lse) and backward (dq, dk, dv)."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    dt = kfa.DTYPES[q.dtype]
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Sq, Skv, H, K, D, dt, int(causal), window,
        softcap, scale, stream)
    assert err == 0, err
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dvec = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    part = (torch.empty((2, B, Skv, H, D), dtype=torch.float32,
                        device=q.device)
            if q.dtype == torch.bfloat16 else None)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
        None if part is None else part.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, K, D, dt, int(causal),
        window, softcap, scale, stream)
    assert err == 0, err
    return o, lse, dq, dk, dv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the checkout to hold this one against")
    args = ap.parse_args(argv)
    lib = other_library(pathlib.Path(args.other).resolve())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    ok = True
    for name, B, Sq, Skv, H, K, D, causal, window, cap, dtype in CASES:
        gen.manual_seed(Sq + Skv + D)
        dt = getattr(torch, dtype)
        q, do = (torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn((B, Skv, K, D), generator=gen, device=dev).to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=0)
        o, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)
        grads = kfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = other_run(lib, q, k, v, do, causal, window, cap,
                         1.0 / math.sqrt(D))
        torch.cuda.synchronize()
        equal = {n: bool(torch.equal(a, b)) for n, a, b in
                 zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads), want)}
        ok = ok and all(equal.values())
        print(json.dumps(dict(case=name, B=B, Sq=Sq, Skv=Skv, H=H, K=K, D=D,
                              causal=causal, window=window, softcap=cap,
                              dtype=dtype, equal=equal)), flush=True)
    print(json.dumps({"offset0_bit_for_bit": ok,
                      "card": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
