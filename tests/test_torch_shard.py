"""The port's mesh and sharding tooling against the JAX reference, on the
CPU.

* ``distributed.auto_shard``: ``auto_spec`` and ``batch_seq_spec`` in
  the reference's five cases on its ``_FakeMesh``; the spec of every
  parameter of all ten architectures at their published widths on 16x16
  and 2x16x16 (the reference's stacked leaf with its leading ``repeats``
  entry dropped) and ``sharded_bytes`` of the whole training state, both
  exactly the reference's; ``placements`` giving each rank of a fake
  512-rank group the shard the reference's layout gives it;
* ``configs.registry.cache_specs``: the reference's cache shapes and
  dtypes per layer at ``decode_32k`` and ``long_500k``;
* ``ModelConfig.active_param_count``: the reference's;
* ``distributed.roofline.roofline_terms`` at the reference's constants
  and ``distributed.cost._ici_bytes``: the reference's to 1e-12;
* ``distributed.act_sharding``: off a mesh the anchors change nothing
  (forward outputs bit for bit); the kernel layer imports no
  ``repro_torch.distributed``; a sharded layer's cache names are a plain
  prefill's;
* the sharded train step on 4 gloo ranks, a (2, 2) mesh, against the
  unsharded one (``launch/shard_check.py``; 1e-5 of the largest
  parameter), a planted fault failing that limit, and the collectives
  ``CommDebugMode`` saw equal to the cost analyser's count on a fake
  (2, 2) group.
"""
import functools
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as JR
from repro.distributed import auto_shard as JA
from repro.distributed import hlo as JH
from repro.distributed import roofline as JRL
from repro.launch import steps as JS
from repro.models import common as JC
from repro_torch.configs import registry as TR
from repro_torch.distributed import auto_shard as TA
from repro_torch.distributed import cost as TC
from repro_torch.distributed import roofline as TRL
from repro_torch.distributed.act_sharding import activation_sharding
from repro_torch.launch import shard_check, steps as TS
from repro_torch.models import LM
from repro_torch.models import common as TCM

ARCHS = TR.list_archs()
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


class _FakeMesh:
    """The reference's test mesh (``tests/test_hlo.py``)."""

    def __init__(self, axes):
        self.shape = dict(axes)
        self.axis_names = tuple(self.shape)


POD = _FakeMesh([("data", 16), ("model", 16)])
MULTIPOD = _FakeMesh([("pod", 2), ("data", 16), ("model", 16)])
MESHES = {"16x16": POD, "2x16x16": MULTIPOD}


def _norm(spec) -> tuple:
    """A spec's entries with a lone axis name as a 1-tuple (jax's
    ``PartitionSpec`` keeps ``("model",)`` as ``"model"``)."""
    return tuple((e,) if isinstance(e, str) else e for e in spec)


def _same(spec, ref) -> bool:
    return _norm(spec) == _norm(ref)


# --- the reference's five cases -----------------------------------------
@pytest.mark.parametrize("case", [
    lambda A: A.auto_spec((40, 5120, 17920), POD, min_elems=0),
    lambda A: A.auto_spec((4, 4, 192, 192), POD),
    lambda A: A.batch_seq_spec(POD, 256, 4096),
    lambda A: A.batch_seq_spec(POD, 32, 32768),
    lambda A: A.batch_seq_spec(MULTIPOD, 256, 4096),
], ids=["divisibility", "small_leaf", "full_batch", "seq_parallel",
        "multipod"])
def test_rule_cases_match_reference(case):
    assert _same(case(TA), case(JA))


def test_spec_is_a_tuple_of_entries():
    spec = TA.batch_seq_spec(POD, 32, 32768)
    assert spec == TA.Spec(("data",), ("model",))
    assert _same(spec, P(("data",), ("model",)))
    assert repr(spec) == "Spec(('data',), ('model',))"


# --- every parameter of the ten architectures ----------------------------
@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return JS.train_state_shapes(JR.get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    return TS.train_state_shapes(TR.get_config(arch))


def _ref_layer_specs(cfg, ref_specs):
    """The reference's group specs unstacked into the port's layer order:
    each stacked leaf's spec with its leading (repeats) entry dropped,
    which must be None."""
    from repro_torch.models.model import model_groups
    layers = []
    for (pattern, reps), group in zip(model_groups(cfg), ref_specs):
        for _ in range(reps):
            for j in range(len(pattern)):
                layers.append(jax.tree.map(
                    lambda s: (s[0], _norm(s)[1:]), group[str(j)],
                    is_leaf=lambda x: isinstance(x, P)))
    return layers


def _flat(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, (P, TA.Spec)) or (isinstance(x, tuple) and len(x) == 2
                             and isinstance(x[1], tuple)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_bytes_match_reference(arch, mesh):
    m = MESHES[mesh]
    cfg = TR.get_config(arch)
    ref_shapes, port_shapes = _ref_state(arch), _port_state(arch)
    ref = JS.state_specs(JR.get_config(arch), m, ref_shapes)
    got = TS.state_specs(cfg, m, port_shapes)
    rp, gp = ref["params"], got["params"]
    for name in rp:
        if name in ("groups", "encoder"):
            continue
        assert [_norm(s) for s in _flat(gp[name])] == \
            [_norm(s) for s in _flat(rp[name])], name
    want = _ref_layer_specs(cfg, rp["groups"])
    assert len(want) == len(gp["layers"])
    n = 0
    for w_layer, g_layer in zip(want, gp["layers"]):
        for w, g in zip(_flat(w_layer), _flat(g_layer)):
            assert w[0] is None and _norm(g) == w[1], (w, g)
            n += 1
    if "encoder" in rp:
        enc = rp["encoder"]["layers"]
        for g_layer in gp["encoder"]["layers"]:
            for w, g in zip(_flat(enc), _flat(g_layer)):
                assert w[0] is None and _norm(g) == _norm(w)[1:]
    assert n > 0
    assert TA.sharded_bytes(port_shapes, got, m) == \
        JA.sharded_bytes(ref_shapes, ref, m)


def test_stacked_leaf_judged_on_its_stack():
    """A 0.5 M-element layer leaf of a 26-layer group is sharded, as the
    reference shards the stacked leaf; alone it is replicated."""
    shape = (256, 2048)
    assert TA.auto_spec(shape, POD) == TA.Spec(None, None)
    got = TA.auto_spec(shape, POD, skip_leading=True, repeats=26)
    want = JA.auto_spec((26,) + shape, POD, skip_leading=True)
    assert want[0] is None and _norm(got) == _norm(want)[1:]
    assert got != TA.Spec(None, None)


def test_sharded_layer_dim_raises():
    with pytest.raises(ValueError, match="layer dim"):
        TA.auto_spec((5, 3), _FakeMesh([("data", 16)]), repeats=16,
                     min_elems=0)


# --- placements on a fake 512-rank group ---------------------------------
_LAYOUT_SCRIPT = r"""
import json, sys, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed.auto_shard import Spec, placements
from repro_torch.launch.mesh import make_production_mesh
from torch.distributed.tensor import distribute_tensor
t = torch.arange(1024 * 32 * 3.).reshape(1024, 32, 3)
# (spec, reorder, the shard of the rank at coordinate c): in mesh order
# the reference's layout (an entry's axes major to minor); against it,
# with reorder, the mesh's order
cases = [
    (Spec(("pod", "data"), ("model",), None), False,
     lambda c: t.chunk(32, 0)[c["pod"] * 16 + c["data"]].chunk(16, 1)[
         c["model"]]),
    (Spec(("data", "model", "pod"), None, None), True,
     lambda c: t.chunk(512, 0)[(c["pod"] * 16 + c["data"]) * 16
                               + c["model"]]),
]
wrong = []
for rank in (0, 1, 17, 255, 256, 300, 511):
    dist.init_process_group("fake", rank=rank, world_size=512,
                            store=FakeStore())
    mesh = make_production_mesh(multi_pod=True)
    c = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for i, (spec, reorder, want) in enumerate(cases):
        local = distribute_tensor(t, mesh, placements(spec, mesh,
                                                      reorder=reorder),
                                  src_data_rank=None).to_local()
        if not torch.equal(local, want(c)):
            wrong.append((rank, i))
    try:
        placements(cases[1][0], mesh)
        wrong.append("no raise")
    except ValueError:
        pass
    dist.destroy_process_group()
print(json.dumps(wrong))
"""


def test_placements_keep_the_reference_layout():
    """Every rank tried holds the shard of the reference's layout where a
    spec's entries follow the mesh's order; an entry against it (pod last
    on 2x16x16) raises, or with ``reorder`` is laid out in mesh order."""
    out = subprocess.run([sys.executable, "-c", _LAYOUT_SCRIPT],
                         capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reordered_leaves_counted():
    cfg = TR.get_config("recurrentgemma-2b")
    shapes = _port_state("recurrentgemma-2b")
    assert TA.count_reordered(TS.state_specs(cfg, MULTIPOD, shapes),
                              MULTIPOD) > 0
    assert TA.count_reordered(TS.state_specs(cfg, POD, shapes), POD) == 0


def _env():
    import os
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    return {"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin",
            "HOME": os.environ.get("HOME", "/tmp")}


# --- caches, counts, roofline --------------------------------------------
@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ARCHS for s in ("decode_32k", "long_500k")
    if TCM.shape_applicable(TR.get_config(a), TCM.SHAPES[s])[0]])
def test_cache_specs_match_reference(arch, shape):
    jcfg, cfg = JR.get_config(arch), TR.get_config(arch)
    want = JR.cache_specs(jcfg, JC.SHAPES[shape])
    got = TR.cache_specs(cfg, TCM.SHAPES[shape])
    assert tuple(got["pos"].shape) == want["pos"].shape
    assert got["pos"].dtype == DTYPES[want["pos"].dtype] == torch.int32
    layers = _ref_layer_specs_shapes(cfg, want["layers"])
    assert len(layers) == len(got["layers"])
    for w_layer, g_layer in zip(layers, got["layers"]):
        assert sorted(w_layer) == sorted(g_layer)
        for k, w in w_layer.items():
            g = g_layer[k]
            assert g.is_meta
            assert tuple(g.shape) == w.shape[1:], k
            assert g.dtype == DTYPES[w.dtype], k


def _ref_layer_specs_shapes(cfg, groups):
    from repro_torch.models.model import model_groups
    return [group[str(j)] for (pattern, reps), group in
            zip(model_groups(cfg), groups)
            for _ in range(reps) for j in range(len(pattern))]


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_matches_reference(arch):
    assert TR.get_config(arch).active_param_count() == \
        JR.get_config(arch).active_param_count()
    assert TR.get_config(arch).has_decoder()


_COSTS = [{"flops": 3.2e14, "bytes accessed": 1.1e12},
          {"flops": 1e9, "bytes accessed": 7.5e11},
          {"flops": 0.0, "bytes accessed": 0.0}]


@pytest.mark.parametrize("i", range(3))
def test_roofline_terms_match_reference_at_its_constants(i):
    hw = TRL._HW(JRL.HW.peak_flops, JRL.HW.hbm_bw, JRL.HW.ici_bw)
    ici = [4e9, 1e12, 0.0][i]
    model = [1.5e14, None, 2e13][i]
    want = JRL.roofline_terms(_COSTS[i], ici, model_flops_per_chip=model)
    got = TRL.roofline_terms(_COSTS[i], ici, model_flops_per_chip=model,
                             hw=hw)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w
        else:
            assert got[k] == pytest.approx(w, rel=1e-12, abs=0.0)


def test_h100_constants():
    assert (TRL.HW.peak_flops, TRL.HW.hbm_bw, TRL.HW.ici_bw) == \
        (989e12, 3.35e12, 450e9)
    assert (TRL.PEAK_F32_FLOPS, TRL.PEAK_BF16_FLOPS, TRL.PEAK_BYTES) == \
        (67e12, 989e12, 3.35e12)


@pytest.mark.parametrize("group", [1, 2, 16, 256])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_ici_bytes_match_reference(kind, group):
    for rb in (0, 4096, 123_456_789):
        assert TC._ici_bytes(kind, rb, group) == pytest.approx(
            JH._ici_bytes(kind, rb, group), rel=1e-12, abs=0.0)


# --- cost analyser ---------------------------------------------------------
def test_cost_counts_local_shards_and_collectives():
    """A batch-sharded product on a fake (2, 2) group: the counter sees
    each rank's quarter of the FLOPs, and the all-gather of the weight's
    shards, not the global op."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, \
        distribute_tensor
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_local_mesh
    with fake_world(4):
        mesh = make_local_mesh((2, 2))
        x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                              [Shard(0), Shard(0)], src_data_rank=None)
        w = distribute_tensor(torch.empty(32, 48, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        cost = TC.analyze(lambda: torch.matmul(x, w.redistribute(
            mesh, [Replicate(), Replicate()])))
    assert not dist.is_initialized()
    assert cost["flops"] == 2 * 64 * 32 * 48 / 4
    assert cost["collective_counts"] == {"all-gather": 1}
    assert cost["ici_bytes"] == pytest.approx(32 * 48 * 4 * 0.5)


def test_kernel_launches_are_charged_by_their_work():
    from repro_torch.kernels import work
    with TC.counting() as c:
        work.charge("rglru_scan", work.scan_work, 1, 3000, 2560)
    work.charge("rglru_scan", work.scan_work, 1, 8, 8)   # no block open
    r = c.result()
    assert r["kernels"] == {"rglru_scan": {
        "launches": 1, "flops": 3 * 3000 * 2560, "bytes": 12 * 3000 * 2560}}
    assert r["flops"] == 3 * 3000 * 2560


# --- activation anchors off a mesh ----------------------------------------
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-moe-3b-a800m"])
def test_anchors_change_nothing_off_mesh(arch):
    cfg = TR.get_config(arch).reduced()
    model = LM(cfg)
    params = model.init(0, "cpu")
    batch = TR.concrete_inputs(cfg, TCM.ShapeSpec("t", 24, 2, "train"),
                               device="cpu")
    plain, aux = model.forward(params, batch)
    with activation_sharding(TA.Spec(("data",), ("model",))):
        anchored, aux2 = model.forward(params, batch)
    assert torch.equal(plain, anchored) and torch.equal(aux, aux2)


# --- one region a layer -----------------------------------------------------
def test_kernel_layer_imports_no_distributed_package():
    """The kernels and the region helpers import nothing of
    ``repro_torch.distributed`` (whose package imports ``kernels.ops``
    back) and nothing of ``torch.distributed.tensor``."""
    code = ("import sys, repro_torch._dtensor, repro_torch.kernels.ops; "
            "print([m for m in sys.modules if m.startswith("
            "('repro_torch.distributed', 'torch.distributed.tensor'))])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_names_are_the_prefill_entries(arch):
    """A sharded prefill names each layer's cache outputs before the
    layer runs (``model._cache_names``): the names of every entry a plain
    prefill collects, in order."""
    from repro_torch.models.model import _cache_names
    cfg = TR.get_config(arch).reduced()
    model = LM(cfg)
    batch = TR.concrete_inputs(cfg, TCM.ShapeSpec("t", 16, 1, "prefill"),
                               device="cpu")
    cache, _ = model.prefill(model.init(0, "cpu"), batch, 24)
    for spec, entry in zip(model.specs, cache["layers"]):
        assert list(entry) == _cache_names(spec, cfg), (spec, list(entry))


# --- the sharded step on 4 gloo ranks --------------------------------------
@pytest.mark.parametrize("batch", [4, 2])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-moe-3b-a800m"])
def test_sharded_step_on_four_gloo_ranks(arch, batch, tmp_path):
    """2 AdamW steps on a (2, 2) mesh of 4 gloo ranks (batch 4 x 16; batch
    2 x 16 leaves "model" to the sequence, so the step runs
    sequence-parallel) within 1e-5 of the largest parameter of the
    unsharded steps, on every rank; with each gradient's sum over the
    batch shards dropped, past it (batch 2: also with the pending sum of
    the gathered keys' and values' gradients dropped); the collectives of
    the first step equal the cost analyser's count of it on a fake
    (2, 2) group."""
    faults = (False, True) + (("gathered",) if batch == 2 else ())
    normal, *faulty = shard_check.run_ranks(
        4, arch, (2, 2), batch, 16, 2, faults=faults, timeout_s=240,
        work=str(tmp_path))
    for r in normal:
        assert r["rel_err"] <= shard_check.LIMIT, r
        assert np.allclose(r["losses"], r["plain_losses"], rtol=1e-5)
        assert r["seq_axes"] == (["model"] if batch == 2 else None)
    for fault in faulty:
        assert all(r["rel_err"] > shard_check.LIMIT for r in fault), fault
    cfg = TR.get_config(arch).reduced()
    cost = shard_check.fake_cost(cfg,
                                 TCM.ShapeSpec("check", 16, batch, "train"),
                                 (2, 2))
    assert cost["collective_counts"] == normal[0]["comms"]
    import torch.distributed as dist
    assert not dist.is_initialized()
