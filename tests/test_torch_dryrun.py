"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
reference's cell, on the CPU.

* the reference's dry-run cell (``tests/test_dryrun_cell.py``):
  xlstm-125m, ``long_500k``, the 16x16 pod mesh, through the CLI in a
  subprocess: an ``ok`` record of 256 devices with H100 roofline terms,
  whose argument bytes a device equal the reference's ``sharded_bytes``
  of the same cell (the compute-dtype parameters and the decode cache
  under the reference's specs, from ``jax.eval_shape``), exactly, and
  whose ``memory`` has the reference's keys but generated code, the peak
  at or above the argument bytes and peak = argument + output - alias +
  temp;
* a cell run in process leaves no process group behind, and skips where
  the reference skips with its reason;
* ``apply_opts``: the reference's knobs, and ``scan=`` refused.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


class _FakeMesh:
    def __init__(self, axes):
        self.shape = dict(axes)
        self.axis_names = tuple(self.shape)


def _reference_decode_arg_bytes(arch: str, shape: str) -> int:
    """The reference's ``run_cell`` argument bytes of a decode cell."""
    from repro.configs.registry import get_config
    from repro.distributed.auto_shard import sharded_bytes
    from repro.launch import steps as JS
    from repro.models.common import SHAPES
    cfg, mesh = get_config(arch), _FakeMesh([("data", 16), ("model", 16)])
    p_shapes = JS.cast_param_shapes(JS.train_state_shapes(cfg)["params"],
                                    cfg.compute_dtype)
    p_specs = JS.state_specs(cfg, mesh, {"params": p_shapes,
                                         "opt": None})["params"]
    cshapes, cspecs, _ = JS.decode_specs(cfg, SHAPES[shape], mesh)
    return (sharded_bytes(p_shapes, p_specs, mesh)
            + sharded_bytes(cshapes, cspecs, mesh))


def test_dryrun_single_cell(tmp_path):
    out = tmp_path / "dry"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "xlstm-125m", "--shape", "long_500k", "--mesh", "pod",
         "--out", str(out)],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", str(tmp_path))},
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    rec = json.loads(
        (out / "xlstm-125m__long_500k__16x16.json").read_text())
    assert rec["ok"] and rec["n_devices"] == 256
    assert rec["roofline"]["t_compute_s"] >= 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["kernels"] == "meta" and rec["trace_s"] > 0
    assert rec["memory"]["argument_size_in_bytes"] == \
        rec["arg_bytes_per_device"] == \
        _reference_decode_arg_bytes("xlstm-125m", "long_500k")
    mem = rec["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "alias_size_in_bytes", "temp_size_in_bytes",
                        "peak_memory_in_bytes"}
    assert all(isinstance(v, int) for v in mem.values())
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"]
    assert mem["output_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert mem["peak_memory_in_bytes"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        - mem["alias_size_in_bytes"] + mem["temp_size_in_bytes"])
    assert any("generated_code" in n for n in rec["memory_notes"])


def test_cell_in_process_leaves_no_process_group(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("xlstm-125m", "decode_32k", False, tmp_path,
                          verbose=False)
    assert rec["ok"] and not rec.get("skipped"), rec.get("error")
    assert rec["arg_bytes_per_device"] == \
        _reference_decode_arg_bytes("xlstm-125m", "decode_32k")
    assert rec["collectives"]["counts"] and \
        rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert not dist.is_initialized()
    skip = dryrun.run_cell("granite-8b", "long_500k", False, tmp_path,
                           verbose=False)
    from repro.models.common import SHAPES, shape_applicable
    from repro.configs.registry import get_config
    reason = shape_applicable(get_config("granite-8b"),
                              SHAPES["long_500k"])[1]
    assert skip["ok"] and skip["skipped"] and skip["skip_reason"] == reason
    assert json.loads((tmp_path / "granite-8b__long_500k__16x16.json")
                      .read_text())["skipped"]


def test_apply_opts():
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import apply_opts
    cfg = apply_opts(get_config("granite-8b"),
                     "remat=none,dtype=float32,capacity=2")
    assert (cfg.remat, cfg.dtype, cfg.capacity_factor) == \
        ("none", "float32", 2.0)
    with pytest.raises(ValueError, match="scan"):
        apply_opts(get_config("granite-8b"), "scan=off")
    with pytest.raises(ValueError, match="unknown opt"):
        apply_opts(get_config("granite-8b"), "bogus=1")
