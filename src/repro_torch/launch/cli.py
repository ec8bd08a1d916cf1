"""The CLI verbs (paper §3.1), model- and language-agnostic:

  python -m repro_torch.launch.cli cluster create -f cluster.yml
  python -m repro_torch.launch.cli run -f experiment.yml [--cluster NAME]
  python -m repro_torch.launch.cli status EXPERIMENT_ID
  python -m repro_torch.launch.cli logs [--follow] EXPERIMENT_ID
  python -m repro_torch.launch.cli delete EXPERIMENT_ID
  python -m repro_torch.launch.cli cluster destroy -n CLUSTER_NAME

Each takes ``--store DIR`` and ``--device`` before the verb: the
suggestion service fits its GP, and trials are handed devices, on the
CUDA card unless ``--device cpu`` is given.

`run` executes the experiment's entrypoint ("module:function") under the
scheduler; with --background it prints the experiment id at once and
keeps the scheduler alive until the run ends (Ctrl-C deletes it), to be
watched from another shell with status/logs — the paper's split-screen
workflow (Fig. 4).  The store's layout is the JAX package's, so either
CLI reads what the other wrote.

The remote verbs (`serve-api`, `serve-fleet`, and `--service` /
`--fleet` on `run` and `status`) need the HTTP transport and the fleet,
which are not ported yet (ROADMAP.md §1 item 3): they raise
``NotImplementedError``.  YAML is read only by the verbs that take a
file, so importing this module needs no PyYAML.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.core.experiment import ExperimentConfig
from repro_torch.core.monitor import (format_cluster_status,
                                      format_experiment_status)
from repro_torch.core.orchestrator import NOT_PORTED, Orchestrator


def _load(path: str):
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch",
                                 description="Orchestrate-PyTorch CLI")
    ap.add_argument("--store", default=".orchestrate")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_cluster = sub.add_parser("cluster")
    csub = p_cluster.add_subparsers(dest="ccmd", required=True)
    c_create = csub.add_parser("create")
    c_create.add_argument("-f", "--file", required=True)
    c_destroy = csub.add_parser("destroy")
    c_destroy.add_argument("-n", "--name", required=True)
    c_status = csub.add_parser("status")
    c_status.add_argument("-n", "--name", required=True)

    p_run = sub.add_parser("run")
    p_run.add_argument("-f", "--file", required=True)
    p_run.add_argument("--cluster", default=None)
    p_run.add_argument("--background", action="store_true")
    p_run.add_argument("--service", default=None, metavar="URL",
                       help="not ported yet (ROADMAP.md §1 item 3)")
    p_run.add_argument("--fleet", default=None, metavar="URL",
                       help="not ported yet (ROADMAP.md §1 item 3)")
    p_run.add_argument("--resume", default=None, metavar="EXPERIMENT_ID",
                       help="resume an existing experiment id")

    for verb in ("serve-api", "serve-fleet"):
        sub.add_parser(verb, help="not ported yet (ROADMAP.md §1 item 3)")

    p_status = sub.add_parser("status")
    p_status.add_argument("experiment_id")
    p_status.add_argument("--service", default=None, metavar="URL",
                          help="not ported yet (ROADMAP.md §1 item 3)")
    p_status.add_argument("--fleet", default=None, metavar="URL",
                          help="not ported yet (ROADMAP.md §1 item 3)")

    p_logs = sub.add_parser("logs")
    p_logs.add_argument("experiment_id")
    p_logs.add_argument("--follow", action="store_true")

    p_delete = sub.add_parser("delete")
    p_delete.add_argument("experiment_id")

    sub.add_parser("list")

    args = ap.parse_args(argv)
    if args.cmd in ("serve-api", "serve-fleet") or (
            args.cmd in ("run", "status") and (args.service or args.fleet)):
        raise NotImplementedError(f"{args.cmd}: {NOT_PORTED}")
    orch = Orchestrator(args.store, device=args.device)

    if args.cmd == "cluster":
        if args.ccmd == "create":
            cluster = orch.cluster_create(_load(args.file))
            print(f"cluster {cluster.name!r} created")
            print(format_cluster_status(cluster.status()))
        elif args.ccmd == "destroy":
            ok = orch.cluster_destroy(args.name)
            print(f"cluster {args.name!r} "
                  f"{'destroyed' if ok else 'not found'}")
            print("experiment records remain in the store")
            return 0 if ok else 1
        else:
            print(format_cluster_status(orch.cluster_status(args.name)))
        return 0

    if args.cmd == "run":
        from repro_torch.api.protocol import ApiError
        cfg = ExperimentConfig.from_json(_load(args.file))
        try:
            exp_id = orch.run(cfg, cluster=args.cluster,
                              background=args.background,
                              exp_id=args.resume)
        except ApiError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(f"experiment {exp_id} "
              f"{'started' if args.background else 'complete'}")
        if not args.background:
            print(format_experiment_status(exp_id, orch.status(exp_id)))
        else:
            # foreground process keeps the background scheduler alive
            try:
                while orch.status(exp_id).get("state") == "running":
                    time.sleep(0.5)
            except KeyboardInterrupt:
                orch.delete(exp_id)
        return 0

    if args.cmd == "status":
        from repro_torch.api.protocol import ApiError
        try:
            st = orch.status(args.experiment_id)
        except ApiError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(format_experiment_status(args.experiment_id, st))
        return 0

    if args.cmd == "logs":
        for line in orch.logs(args.experiment_id, follow=args.follow):
            print(line)
        return 0

    if args.cmd == "delete":
        orch.delete(args.experiment_id)
        print(f"experiment {args.experiment_id} deleted "
              f"(records remain in the store)")
        return 0

    if args.cmd == "list":
        for e in orch.store.list_experiments():
            st = orch.store.get_status(e)
            print(f"{e}  {st.get('state', '?'):10s} "
                  f"obs={st.get('observations', 0)}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
