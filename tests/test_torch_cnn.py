"""The paper's §4 CNN in the port (``repro_torch.models.cnn``) against the
JAX reference, on the CPU.

* ``synthetic_signs`` equals the reference's bit for bit (numpy both);
* from the reference's own initialisation, carried over by
  ``cnn_params_from_reference`` (HWIO -> OIHW), the logits and the loss
  agree to 1e-5 relative to their largest magnitude, and the gradients
  to 1e-5 in relative norm, per parameter (float32 both: the same
  function summed in other orders);
* ``train_cnn`` with the port's ``init_cnn`` patched to that converted
  initialisation: each reported validation accuracy and the final one
  within 2/256 of the reference's (two of the 256 validation images; 20
  steps of momentum SGD carry the rounding differences along);
* the reference's own tests of the CNN (``test_cnn.py``), over the port.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import cnn as J
from repro_torch.models import cnn as T
from repro_torch.models.convert import cnn_params_from_reference

TOL = 1e-5
ACC_TOL = 2 / 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_params(seed, cfg):
    return jax.tree.map(np.asarray, J.init_cnn(jax.random.key(seed), cfg))


def _batch(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.mark.parametrize("seed,n", [(0, 1), (7, 32), (12345, 64)])
def test_synthetic_signs_bit_for_bit(seed, n):
    want, got = J.synthetic_signs(seed, n), T.synthetic_signs(seed, n)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed,fc_width", [(0, 128), (3, 37)])
def test_forward_loss_and_grads_match_reference(seed, fc_width):
    jcfg = J.CNNConfig(fc_width=fc_width)
    tcfg = T.CNNConfig(fc_width=fc_width)
    jp = _ref_params(seed, jcfg)
    data = J.synthetic_signs(seed + 100, 48)
    want_logits = np.asarray(J.cnn_forward(jp, data["image"], jcfg))
    (want_loss, want_acc), want_g = jax.value_and_grad(
        lambda p: J.cnn_loss(p, data, jcfg), has_aux=True)(jp)

    tp = cnn_params_from_reference(jp)
    leaves = {(n, k): t.requires_grad_() for n, layer in tp.items()
              for k, t in layer.items()}
    logits = T.cnn_forward(tp, torch.from_numpy(data["image"]), tcfg)
    got = logits.detach().numpy()
    scale = np.abs(want_logits).max()
    assert np.abs(got - want_logits).max() <= TOL * scale
    loss, acc = T.cnn_loss(tp, _batch(data), tcfg)
    assert abs(loss.item() - float(want_loss)) <= TOL * abs(float(want_loss))
    assert float(acc) == float(want_acc)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (name, k), g in zip(leaves, grads):
        w = np.asarray(want_g[name][k])
        if name.startswith("conv") and k == "w":
            w = w.transpose(3, 2, 0, 1)
        err = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert err <= TOL, (name, k, err)


@pytest.mark.parametrize("assignment", [
    {"lr": 3e-3, "momentum": 0.9, "fc_width": 64},
    {"lr": 3e-2, "momentum": 0.5, "fc_width": 200},
])
def test_train_cnn_matches_reference(monkeypatch, assignment):
    want_reports, got_reports = [], []
    want = J.train_cnn(assignment, steps=20, seed=1,
                       report=lambda s, v: want_reports.append((s, v)))

    def converted_init(seed, cfg=T.CNNConfig(), device=None):
        jcfg = J.CNNConfig(fc_width=cfg.fc_width)
        return cnn_params_from_reference(_ref_params(seed, jcfg), device)

    monkeypatch.setattr(T, "init_cnn", converted_init)
    got = T.train_cnn(assignment, steps=20, seed=1, device="cpu",
                      report=lambda s, v: got_reports.append((s, v)))
    assert [s for s, _ in got_reports] == [s for s, _ in want_reports] \
        == [9, 19]
    for (_, g), (_, w) in zip(got_reports, want_reports):
        assert abs(g - w) <= ACC_TOL
    assert abs(got - want) <= ACC_TOL


def test_init_cnn_distributions():
    """The reference's shapes and scales (He-normal, zero biases), drawn
    from a seeded torch generator: the same seed gives the same weights."""
    cfg = T.CNNConfig(fc_width=64)
    a, b = T.init_cnn(5, cfg, device="cpu"), T.init_cnn(5, cfg, device="cpu")
    ref = _ref_params(5, J.CNNConfig(fc_width=64))
    for name, layer in a.items():
        w = ref[name]["w"]
        if name.startswith("conv"):
            w = w.transpose(3, 2, 0, 1)
        assert tuple(layer["w"].shape) == w.shape
        assert torch.equal(layer["w"], b[name]["w"])
        assert not layer["b"].any()
        fan_in = int(np.prod(w.shape[1:])) if name.startswith("conv") \
            else w.shape[0]
        std = float(layer["w"].std())
        assert abs(std - np.sqrt(2.0 / fan_in)) <= 0.15 * std


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cnn(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.train_cnn({}, steps=1)


# ------------------------------------- the reference's test_cnn.py, ported
def test_dataset_deterministic_and_labeled():
    a = T.synthetic_signs(7, 32)
    b = T.synthetic_signs(7, 32)
    np.testing.assert_array_equal(a["image"], b["image"])
    assert a["label"].min() >= 0 and a["label"].max() < T.N_CLASSES


def test_cnn_learns_above_chance():
    reports = []
    acc = T.train_cnn({"lr": 3e-3, "momentum": 0.9, "fc_width": 64},
                      steps=50, batch=64, device="cpu",
                      report=lambda s, v: reports.append(v))
    assert acc > 3.0 / T.N_CLASSES          # >> 1/43 chance
    assert reports and reports[-1] >= reports[0] - 0.05


def test_bad_lr_does_worse():
    good = T.train_cnn({"lr": 3e-3, "momentum": 0.9}, steps=40, device="cpu")
    bad = T.train_cnn({"lr": 0.29, "momentum": 0.99}, steps=40, device="cpu")
    assert good > bad or bad < 0.2
