"""The port's cell helpers against the JAX reference, on the CPU.

* ``configs.registry.input_specs``: the same input names, shapes and
  dtypes as the reference's ``jax.ShapeDtypeStruct``s for every
  architecture at its published size and every shape of ``SHAPES``;
* ``configs.registry.concrete_inputs``: bit for bit the reference's
  batch from the same seed at a reduced size, for each cell kind, in
  float32 and in bfloat16;
* ``models.common.shape_applicable``: the reference's verdict and reason
  for every (architecture, shape).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import common as JC
from repro_torch.configs import registry as TR
from repro_torch.models import common as TC

ARCHS = TR.list_archs()
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


def test_both_registries_list_the_same_archs():
    assert ARCHS == JR.list_archs()


@pytest.mark.parametrize("shape", list(JC.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    want = JR.input_specs(JR.get_config(arch), JC.SHAPES[shape])
    got = TR.input_specs(TR.get_config(arch), TC.SHAPES[shape])
    assert list(got) == list(want)
    for name, s in want.items():
        assert got[name] == (tuple(s.shape), DTYPES[jnp.dtype(s.dtype)]), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_concrete_inputs_match_reference_bit_for_bit(arch, kind, dtype):
    jc = JR.get_config(arch).reduced(dtype=dtype)
    tc = TR.get_config(arch).reduced(dtype=dtype)
    want = JR.concrete_inputs(jc, JC.ShapeSpec("smoke", 32, 2, kind), seed=7)
    got = TR.concrete_inputs(tc, TC.ShapeSpec("smoke", 32, 2, kind), seed=7,
                             device="cpu")
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == DTYPES[jnp.dtype(w.dtype)], name
        assert tuple(g.shape) == w.shape, name
        # bfloat16 compared through float32, which holds it exactly
        np.testing.assert_array_equal(
            g.float().numpy() if g.is_floating_point() else g.numpy(),
            np.asarray(w.astype(jnp.float32) if g.is_floating_point()
                       else w))


def test_concrete_inputs_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TR.get_config("whisper-medium").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.concrete_inputs(cfg, TC.SHAPES["train_4k"])


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_matches_reference(arch):
    jc, tc = JR.get_config(arch), TR.get_config(arch)
    assert tc.is_subquadratic() == jc.is_subquadratic()
    for name in JC.SHAPES:
        assert (TC.shape_applicable(tc, TC.SHAPES[name])
                == JC.shape_applicable(jc, JC.SHAPES[name])), name
    # a window on every layer makes any stack sub-quadratic
    local = dataclasses.replace(tc, block_pattern=(TC.LOCAL_ATTN,))
    assert TC.shape_applicable(local, TC.SHAPES["long_500k"]) == (True, "")
