"""The port's CLI (``python -m repro_torch.launch.cli``) on the CPU: the
reference's CLI lifecycle (``test_store_cli.py``) over the port with
``--device cpu``; the verbs that need the unported HTTP transport raise;
importing the module needs no PyYAML; and the two CLIs read each other's
stores, printing the same status, list and cluster lines."""
import pathlib
import subprocess
import sys

import pytest
import torch
import yaml

from repro_torch.launch.cli import main as cli_main

ROOT = pathlib.Path(__file__).resolve().parent.parent


def objective(assignment, ctx):
    ctx.log(f"x={assignment['x']} on {ctx.lease.devices[0]}")
    return -(assignment["x"] - 0.25) ** 2


def _files(tmp_path, budget=6):
    cluster_yml = tmp_path / "cluster.yml"
    cluster_yml.write_text(yaml.safe_dump({
        "cluster_name": "orchestrate-cluster",
        "cloud_provider": "local",
        "pools": [{"name": "gpu", "resource": "gpu", "chips": 8}],
    }))
    exp_yml = tmp_path / "exp.yml"
    exp_yml.write_text(yaml.safe_dump({
        "name": "cli-exp", "budget": budget, "parallel": 3,
        "optimizer": "random",
        "space": [{"name": "x", "type": "double", "bounds": [0, 1]}],
        "resources": {"pool": "gpu", "chips": 2},
        "entrypoint": "tests.test_torch_cli:objective",
    }))
    return str(cluster_yml), str(exp_yml)


def _cli(store, *args):
    return cli_main(["--store", store, "--device", "cpu", *args])


def test_cli_full_lifecycle(tmp_path, capsys):
    store = str(tmp_path / "store")
    cluster_yml, exp_yml = _files(tmp_path)
    assert _cli(store, "cluster", "create", "-f", cluster_yml) == 0
    assert "8/8 chips free" in capsys.readouterr().out
    assert _cli(store, "run", "-f", exp_yml,
                "--cluster", "orchestrate-cluster") == 0
    assert "6 / 6 Observations" in capsys.readouterr().out

    exp_id = sorted((pathlib.Path(store) / "experiments").iterdir())[-1].name
    assert _cli(store, "status", exp_id) == 0
    assert "Observations" in capsys.readouterr().out
    assert _cli(store, "logs", exp_id) == 0
    assert "on cpu" in capsys.readouterr().out     # the lease's device
    assert _cli(store, "list") == 0
    assert f"{exp_id}  complete" in capsys.readouterr().out
    assert _cli(store, "cluster", "status", "-n", "orchestrate-cluster") == 0
    assert "8/8 chips free, 0 active leases" in capsys.readouterr().out
    assert _cli(store, "delete", exp_id) == 0
    # destroying the cluster keeps experiment records (paper §2.6)
    assert _cli(store, "cluster", "destroy", "-n", "orchestrate-cluster") == 0
    assert (pathlib.Path(store) / "experiments" / exp_id /
            "observations.jsonl").exists()
    assert _cli(store, "cluster", "destroy", "-n", "orchestrate-cluster") == 1


@pytest.mark.parametrize("argv", [
    ["serve-api"], ["serve-fleet"],
    ["run", "-f", "exp.yml", "--service", "http://127.0.0.1:1"],
    ["run", "-f", "exp.yml", "--fleet", "http://127.0.0.1:1"],
    ["status", "e1", "--service", "http://127.0.0.1:1"],
])
def test_remote_verbs_name_the_roadmap(tmp_path, argv):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 item 3"):
        _cli(str(tmp_path), *argv)


def test_default_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["--store", str(tmp_path), "list"])


def test_import_needs_no_yaml():
    """The card's machine lists no PyYAML: importing the CLI must not need
    it (only the verbs that read a file import it)."""
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import repro_torch.launch.cli as c\n"
            "print(c.main.__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "main", out.stderr


def _outputs(main, store, exp_id, capsys, *device):
    capsys.readouterr()
    for argv in (["status", exp_id], ["list"],
                 ["cluster", "status", "-n", "orchestrate-cluster"]):
        assert main(["--store", store, *device, *argv]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_clis_read_each_others_stores(tmp_path, capsys, writer):
    from repro.launch.cli import main as ref_main
    store = str(tmp_path / "store")
    cluster_yml, exp_yml = _files(tmp_path, budget=4)
    run = ref_main if writer == "reference" else \
        (lambda argv: cli_main(["--device", "cpu", *argv]))
    assert run(["--store", store, "cluster", "create", "-f", cluster_yml]) \
        == 0
    assert run(["--store", store, "run", "-f", exp_yml,
                "--cluster", "orchestrate-cluster"]) == 0
    exp_id = sorted((pathlib.Path(store) / "experiments").iterdir())[-1].name
    want = _outputs(ref_main, store, exp_id, capsys)
    assert "4 / 4 Observations" in want
    assert _outputs(cli_main, store, exp_id, capsys, "--device", "cpu") == want
