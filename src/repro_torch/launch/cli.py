"""The CLI verbs (paper §3.1), model- and language-agnostic:

  python -m repro_torch.launch.cli cluster create -f cluster.yml
  python -m repro_torch.launch.cli run -f experiment.yml [--cluster NAME]
                                       [--service URL | --fleet URL]
  python -m repro_torch.launch.cli status EXPERIMENT_ID [--service URL]
  python -m repro_torch.launch.cli logs [--follow] EXPERIMENT_ID
  python -m repro_torch.launch.cli delete EXPERIMENT_ID
  python -m repro_torch.launch.cli cluster destroy -n CLUSTER_NAME
  python -m repro_torch.launch.cli serve-api [--host H] [--port N]
  python -m repro_torch.launch.cli serve-fleet [--shards N] [--shard URL]

Each takes ``--store DIR`` and ``--device`` before the verb: the
suggestion service fits its GP, and trials are handed devices, on the
CUDA card unless ``--device cpu`` is given.

`run` executes the experiment's entrypoint ("module:function") under the
scheduler; with --background it prints the experiment id at once and
keeps the scheduler alive until the run ends (Ctrl-C deletes it), to be
watched from another shell with status/logs — the paper's split-screen
workflow (Fig. 4).  The store's layout is the JAX package's, so either
CLI reads what the other wrote.

`serve-api` exposes this store's suggestion service over HTTP (the v1
suggest/observe protocol of API.md, the JAX package's wire byte for
byte), fitting its GP on ``--device``.  A worker in another process or
on another host then drives the same experiment with `run -f exp.yml
--service URL`: suggestions and observations flow through the service,
while trial logs and checkpoints stay in the worker's local store.
`serve-fleet` shards the service across N in-process shards over this
store (and/or attached `serve-api` URLs); `run --fleet URL` routes
through its manager.  Both serve verbs shut down gracefully on SIGTERM
or SIGINT.  YAML is read only by the verbs that take a file, so
importing this module needs no PyYAML, and where PyYAML is missing
those verbs read the file as JSON.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time

from repro_torch.core.experiment import ExperimentConfig
from repro_torch.core.monitor import (format_cluster_status,
                                      format_experiment_status)
from repro_torch.core.orchestrator import Orchestrator


def _load(path: str):
    """A YAML file; without PyYAML, a JSON one (JSON is YAML too)."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return json.loads(text)
    return yaml.safe_load(text)


def _install_graceful_shutdown(shutdown_fn, what: str) -> threading.Event:
    """SIGTERM/SIGINT -> graceful ``shutdown_fn()``.  The handler runs in
    the main thread, which is blocked inside ``serve_forever`` — calling
    ``httpd.shutdown()`` from there would deadlock, so the handler hands
    the work to a helper thread and lets ``serve_forever`` return."""
    fired = threading.Event()

    def handler(signum, frame):
        if fired.is_set():      # second signal: let the default kill us
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        fired.set()
        name = signal.Signals(signum).name
        print(f"\n{what}: {name} received, shutting down gracefully "
              f"(again to force)", file=sys.stderr)
        threading.Thread(target=shutdown_fn, name="graceful-shutdown",
                         daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, handler)
    return fired


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
                       help="drive a remote suggestion service "
                            "(serve-api) instead of in-process")
    p_run.add_argument("--fleet", default=None, metavar="URL",
                       help="drive a sharded fleet through its manager "
                            "(serve-fleet, API.md §Fleet)")
    p_run.add_argument("--resume", default=None, metavar="EXPERIMENT_ID",
                       help="resume an existing experiment id")

    p_serve = sub.add_parser(
        "serve-api", help="serve the v1 suggestion API over HTTP (API.md)")
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8765)

    p_fleet = sub.add_parser(
        "serve-fleet",
        help="serve a sharded fleet: manager + N shards (API.md §Fleet)")
    p_fleet.add_argument("--host", default="127.0.0.1")
    p_fleet.add_argument("--port", type=int, default=8766)
    p_fleet.add_argument("--shards", type=int, default=0, metavar="N",
                         help="spawn N in-process shards over this store")
    p_fleet.add_argument("--shard", action="append", default=[],
                         metavar="URL", dest="shard_urls",
                         help="attach an external serve-api shard "
                              "(repeatable)")
    p_fleet.add_argument("--period", type=float, default=1.0,
                         help="heartbeat period in seconds")
    p_fleet.add_argument("--standby", action="store_true",
                         help="start as a warm standby: watch the active "
                              "manager's lease in the shared store and "
                              "take over (with a bumped leadership term) "
                              "when it goes stale")

    p_status = sub.add_parser("status")
    p_status.add_argument("experiment_id")
    p_status.add_argument("--service", default=None, metavar="URL",
                          help="query a remote suggestion service instead "
                               "of the local store")
    p_status.add_argument("--fleet", default=None, metavar="URL",
                          help="query through a fleet manager "
                               "(routes to the owning shard)")

    p_logs = sub.add_parser("logs")
    p_logs.add_argument("experiment_id")
    p_logs.add_argument("--follow", action="store_true")

    p_delete = sub.add_parser("delete")
    p_delete.add_argument("experiment_id")

    sub.add_parser("list")

    args = ap.parse_args(argv)
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

    if args.cmd == "serve-api":
        from repro_torch.api.http import serve_api
        try:
            server = serve_api(orch.client, host=args.host, port=args.port)
        except OSError as e:
            print(f"cannot bind {args.host}:{args.port}: {e}",
                  file=sys.stderr)
            return 1
        # handler first: the "listening on" line is the readiness signal,
        # and a supervisor may SIGTERM the moment it sees it
        _install_graceful_shutdown(server.shutdown, "serve-api")
        print(f"suggestion service (protocol v1) listening on {server.url}")
        print(f"store: {orch.store.root}  device: {orch.client.device}  "
              f"—  see API.md for the endpoints")
        server.serve_forever()
        print("serve-api: shut down cleanly", file=sys.stderr)
        return 0

    if args.cmd == "serve-fleet":
        from repro_torch.fleet import serve_fleet
        try:
            server = serve_fleet(orch.store, shards=args.shards,
                                 shard_urls=args.shard_urls,
                                 host=args.host, port=args.port,
                                 period=args.period, device=args.device,
                                 standby=args.standby)
        except (OSError, ValueError) as e:
            print(f"cannot start fleet: {e}", file=sys.stderr)
            return 1
        shards = server.manager.shard_map().shards
        _install_graceful_shutdown(server.shutdown, "serve-fleet")
        print(f"fleet manager (protocol v1) listening on {server.url}")
        for sid, url in sorted(shards.items()):
            print(f"  shard {sid}: {url}")
        print(f"store: {orch.store.root}  —  see API.md §Fleet")
        server.serve_forever()
        print("serve-fleet: shut down cleanly", file=sys.stderr)
        return 0

    if args.cmd == "run":
        from repro_torch.api.protocol import ApiError
        cfg = ExperimentConfig.from_json(_load(args.file))
        try:
            exp_id = orch.run(cfg, cluster=args.cluster,
                              background=args.background,
                              exp_id=args.resume, service=args.service,
                              fleet=args.fleet)
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
            if args.fleet:
                from repro_torch.fleet import FleetClient
                client = FleetClient(args.fleet, heartbeat=False)
                try:
                    st = client.status(args.experiment_id).to_json()
                finally:
                    client.close()
            elif args.service:
                from repro_torch.api.http import HTTPClient
                st = HTTPClient(args.service).status(
                    args.experiment_id).to_json()
            else:
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
