"""Status rendering (paper Fig. 4: `sigopt status`) and cluster health."""
from __future__ import annotations

from typing import Any, Dict


def format_experiment_status(exp_id: str, st: Dict[str, Any]) -> str:
    lines = [
        f"Job Name: orchestrate-{exp_id}",
        f"Job Status: "
        f"{'Complete' if st.get('state') == 'complete' else 'Not Complete'}",
        f"Experiment Name: {st.get('name', '?')}",
        f"{st.get('observations', 0)} / {st.get('budget', '?')} Observations",
        f"{st.get('failures', 0)} Observation(s) failed",
    ]
    if st.get("running_trials") is not None:
        lines.append(f"Trial status: {st['running_trials']} Running")
    best = st.get("best")
    if best:
        lines.append(f"Best value: {best.get('value'):.6g} "
                     f"at {best.get('assignment')}")
    lines.append(f"View more in the experiment store "
                 f"(.orchestrate/experiments/{exp_id}/)")
    return "\n".join(lines)


def format_cluster_status(st: Dict[str, Any]) -> str:
    lines = [f"Cluster: {st['name']}"]
    for name, pool in st["pools"].items():
        lines.append(f"  pool {name:8s} [{pool['resource']}] "
                     f"{pool['free']}/{pool['chips']} chips free, "
                     f"{pool['leases']} active leases")
    return "\n".join(lines)
