"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or anything of the JAX package, and the
device default is the CUDA card with no silent CPU fall-back."""
import pathlib
import re
import subprocess
import sys
import tempfile

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_IMPORT_SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
    r"from\s+repro(\.|\s)|import\s+repro(\.|\s|$))", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_source_imports_neither_jax_nor_the_reference(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), _FORBIDDEN.search(text).group(0)


def test_importing_models_loads_no_distributed_tooling():
    """A serving path imports the models, and the models' activation
    anchors (``distributed.act_sharding``) load none of the sharding
    tooling: not the compressed all-reduce, the cost analyser or the
    sharding rules."""
    code = ("import sys, repro_torch.models; print(sorted(m for m in "
            "sys.modules if m in ('repro_torch.distributed.compress', "
            "'repro_torch.distributed.cost', "
            "'repro_torch.distributed.auto_shard')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_resolve_default_needs_cuda(monkeypatch):
    """``resolve`` and the LM's ``init`` / ``init_cache``, which resolve
    their device through it: the card by default, no CPU fall-back."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve
    from repro_torch.models import LM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve()
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cpu")) == torch.device("cpu")
    model = LM(get_config("granite-8b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    params = model.init(device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
    assert model.init_cache(1, 8, device="cpu")["pos"].device.type == "cpu"
    assert model.init(device="meta")["embed"]["table"].is_meta


def test_local_client_default_device_needs_cuda(monkeypatch):
    from repro_torch.api import LocalClient
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        LocalClient(tempfile.mkdtemp())
    assert LocalClient(tempfile.mkdtemp(), device="cpu").device.type == "cpu"


def test_serve_default_device_needs_cuda(monkeypatch):
    """``serve_api`` and ``serve_fleet`` fit on the card by default and
    resolve it when they are built, before any request; ``device="cpu"``
    is the explicit way onto the CPU."""
    from repro_torch.api.http import serve_api
    from repro_torch.fleet import serve_fleet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_api(tempfile.mkdtemp())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_fleet(tempfile.mkdtemp(), shards=1)
    server = serve_api(tempfile.mkdtemp(), device="cpu").start()
    try:
        assert server.backend.device.type == "cpu"
    finally:
        server.shutdown()
    fleet = serve_fleet(tempfile.mkdtemp(), shards=1, device="cpu").start()
    try:
        assert fleet.owned_shards[0].backend.device.type == "cpu"
    finally:
        fleet.shutdown()


def test_cuda_linalg_is_loaded_only_for_the_gp(monkeypatch, tmp_path):
    """Resolving the card does no work on it: an idle worker's
    ``Orchestrator`` (whose ``LocalClient`` a remote run never uses)
    must hold nothing there.  The GP's callers and ``serve_api`` load
    PyTorch's CUDA linear algebra, once, before any thread of theirs."""
    import repro_torch.device as device_mod
    from repro_torch.api.http import serve_api
    from repro_torch.core import Orchestrator
    loaded = []
    monkeypatch.setattr(device_mod, "_load_cuda_linalg", loaded.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device_mod.resolve() == torch.device("cuda")
    orch = Orchestrator(str(tmp_path / "worker"))
    assert orch.client.device.type == "cuda" and loaded == []
    assert device_mod.resolve(linalg=True) == torch.device("cuda")
    assert loaded == [torch.device("cuda")]
    server = serve_api(str(tmp_path / "service"))
    try:
        assert loaded == [torch.device("cuda")] * 2
    finally:
        server._httpd.server_close()
        server.backend.close()


def test_chip_smoke_refuses_to_run_without_cuda():
    """``chip_smoke.py`` exits non-zero and prints no result without a
    card, and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = pathlib.Path(tempfile.mkdtemp())
    (lone / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=lone, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and '"ok"' not in out.stdout
