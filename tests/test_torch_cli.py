"""The port's CLI (``python -m repro_torch.launch.cli``) on the CPU: the
reference's CLI lifecycle (``test_store_cli.py``) over the port with
``--device cpu``; the remote verbs (``serve-api`` and ``serve-fleet`` in
processes of their own, driven by a worker process and stopped by
SIGTERM; ``run`` and ``status`` with ``--service`` / ``--fleet``);
importing the module needs no PyYAML; and the two CLIs read each other's
stores, printing the same status, list and cluster lines."""
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import urllib.request

import pytest
import torch

from repro_torch.launch.cli import main as cli_main

ROOT = pathlib.Path(__file__).resolve().parent.parent


def objective(assignment, ctx):
    ctx.log(f"x={assignment['x']} on {ctx.lease.devices[0]}")
    return -(assignment["x"] - 0.25) ** 2


def _files(tmp_path, budget=6):
    import yaml     # here: ``objective`` must import without PyYAML
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


#: how long a CLI process may take to start, or to run a small budget
PROC_TIMEOUT_S = 120


def _env():
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}",
                PYTHONUNBUFFERED="1")


def _cli_proc(store, *args, timeout=PROC_TIMEOUT_S):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cli", "--store", store,
         "--device", "cpu", *args], capture_output=True, text=True,
        timeout=timeout, env=_env(), cwd=ROOT)


def _serve_proc(store, verb, *extra):
    """Start a serve verb in a process of its own; -> (process, url) once
    it prints its "listening on" line (within ``PROC_TIMEOUT_S``)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.cli", "--store", store,
         "--device", "cpu", verb, "--port", "0", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT)
    line = []
    reader = threading.Thread(target=lambda: line.append(
        proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(PROC_TIMEOUT_S)
    if not line or "listening on" not in line[0]:
        proc.kill()
        raise AssertionError(f"{verb} did not start: "
                             f"{proc.communicate(timeout=30)[1]}")
    return proc, line[0].split("listening on")[1].strip()


def _served_experiment(tmp_path, fleet: bool):
    """A port service (or two-shard fleet) in this process, on the CPU,
    with one completed experiment; -> (server, url, exp_id)."""
    from repro_torch.api.http import serve_api
    from repro_torch.core import ExperimentConfig, Orchestrator, Param, Space
    from repro_torch.fleet import serve_fleet
    root = str(tmp_path / "service")
    server = (serve_fleet(root, shards=2, period=0.2, device="cpu")
              if fleet else serve_api(root, device="cpu")).start()
    cfg = ExperimentConfig(name="served", budget=4, parallel=2,
                           optimizer="random",
                           space=Space([Param("x", "double", 0, 1)]))
    exp = Orchestrator(str(tmp_path / "worker"), device="cpu").run(
        cfg, trial_fn=lambda a, ctx: a["x"],
        **({"fleet": server.url} if fleet else {"service": server.url}))
    return server, server.url, exp


@pytest.mark.parametrize("argv", [
    ["serve-api"], ["serve-fleet"],
    ["run", "-f", "exp.yml", "--service", "{url}"],
    ["run", "-f", "exp.yml", "--fleet", "{url}"],
    ["status", "{exp}", "--service", "{url}"],
    ["status", "{exp}", "--fleet", "{url}"],
])
def test_remote_verbs_name_the_roadmap(tmp_path, capsys, argv):
    """Each remote verb runs on the CPU.  The serve verbs start in a
    process of their own, serve a worker process that creates a cluster
    and runs a small budget through them (``run --service`` /
    ``--fleet``), and exit cleanly on SIGTERM; ``run`` and ``status`` go
    through a port service or fleet in this process."""
    cluster_yml, exp_yml = _files(tmp_path)
    if argv[0].startswith("serve-"):
        served = str(tmp_path / "served")
        fleet = argv[0] == "serve-fleet"
        proc, url = _serve_proc(served, argv[0],
                                *(["--shards", "2"] if fleet else []))
        try:
            health = "/fleet/healthz" if fleet else "/v1/healthz"
            with urllib.request.urlopen(url + health, timeout=30) as r:
                assert r.status == 200
            worker = str(tmp_path / "worker")
            assert _cli_proc(worker, "cluster", "create", "-f",
                             cluster_yml).returncode == 0
            out = _cli_proc(worker, "run", "-f", exp_yml, "--cluster",
                            "orchestrate-cluster",
                            "--fleet" if fleet else "--service", url)
            assert out.returncode == 0, out.stderr
            assert "6 / 6 Observations" in out.stdout
            exps = list((pathlib.Path(served) / "experiments").iterdir())
            assert len(exps) == 1 and len((exps[0] / "observations.jsonl")
                                          .read_text().splitlines()) == 6
        finally:
            proc.send_signal(signal.SIGTERM)
            _, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err
        assert "shut down cleanly" in err, err
        return
    fleet = "--fleet" in argv
    server, url, exp = _served_experiment(tmp_path, fleet)
    try:
        args = [a.format(url=url, exp=exp) for a in argv]
        if argv[0] == "run":
            args[2] = exp_yml
            assert _cli(str(tmp_path / "cli"), "cluster", "create", "-f",
                        cluster_yml) == 0
            args += ["--cluster", "orchestrate-cluster"]
            capsys.readouterr()
        assert _cli(str(tmp_path / "cli"), *args) == 0
        out = capsys.readouterr().out
        assert ("6 / 6 Observations" if argv[0] == "run"
                else "4 / 4 Observations") in out, out
    finally:
        server.shutdown()


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


def test_files_read_as_json_without_yaml(tmp_path):
    """Where PyYAML is missing, the verbs that take a file read it as
    JSON: a cluster and a small run from JSON files."""
    cluster = tmp_path / "cluster.json"
    cluster.write_text(json.dumps({"cluster_name": "c", "pools": [
        {"name": "gpu", "resource": "gpu", "chips": 2}]}))
    exp = tmp_path / "exp.json"
    exp.write_text(json.dumps({
        "name": "json-exp", "budget": 3, "parallel": 1,
        "optimizer": "random", "resources": {"pool": "gpu", "chips": 1},
        "space": [{"name": "x", "type": "double", "bounds": [0, 1]}],
        "entrypoint": "tests.test_torch_cli:objective"}))
    store = str(tmp_path / "store")
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from repro_torch.launch.cli import main\n"
            f"s = ['--store', {store!r}, '--device', 'cpu']\n"
            f"assert main(s + ['cluster', 'create', '-f', {str(cluster)!r}])"
            " == 0\n"
            f"sys.exit(main(s + ['run', '-f', {str(exp)!r}, '--cluster', "
            "'c']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=PROC_TIMEOUT_S, env=_env(),
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "3 / 3 Observations" in out.stdout


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
