"""What the benchmark's files promise:

- a run loads no module whose top-level name is ``jax``, ``jaxlib``,
  ``flax`` or ``repro`` (the JAX package the port was made from),
  compared whole; the references load nothing of ``repro_torch``; and
  nothing under ``portbench/`` reads the old ``benchmarks/`` folder;
- each configuration file's ``as_run`` differs from its ``published``
  exactly in the keys ``BENCHMARK.json`` lists under ``reduced``, and
  agrees with the ``run`` block the program is built from;
- ``BENCHMARK.json`` keeps the shape of the benchmark's contract.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[1]
BASE = ROOT / "portbench"


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_reference_package():
    names = _modules_after(
        "from portbench import harness, faults, readings, tiny\n"
        "from portbench.program import model_config, shapes\n"
        "s = tiny.suite()\n"
        "for w in s.spec['workloads']:\n"
        "    c = s.cell(w['name'])\n"
        "    shapes(model_config(c.run_config))\n"
        "    for m in s.metrics(w['name'], True): s.reader(m['name'])\n")
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)
    assert "repro_torch" in names


def test_references_load_nothing_of_the_port():
    names = _modules_after(
        "from portbench import harness\n"
        "from portbench.reference import common\n"
        "for f in ('moe_decoder', 'encdec'):\n"
        "    harness.load_module(harness.ROOT / 'portbench' / 'reference'"
        " / (f + '.py'))\n")
    assert not names & ({"repro_torch"} | set(harness.FORBIDDEN))


def test_nothing_reads_the_old_benchmarks_folder():
    rx = re.compile(r"""(^|["'/\s])benchmarks(/|["'])""")
    for path in BASE.rglob("*"):
        if path.suffix in (".py", ".json") and not path.name.startswith("test_"):
            assert not rx.search(path.read_text()), path


def test_reduced_lists_exactly_the_changed_keys():
    from portbench import tiny
    for entry in tiny.suite().spec["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        changed = sorted(k for k in cfg["published"]
                         if cfg["published"][k] != cfg["as_run"][k])
        assert changed == sorted(entry["reduced"]), entry["name"]
        assert set(cfg["as_run"]) == set(cfg["published"])
        assert cfg["source"] == entry.get("source", cfg["source"])


def test_as_run_is_the_run_block():
    g = json.loads((BASE / "configs" / "granite-moe-3b-a800m-d4.json")
                   .read_text())
    a, r = g["as_run"], g["run"]
    assert (a["num_hidden_layers"], a["hidden_size"],
            a["num_attention_heads"], a["num_key_value_heads"],
            a["intermediate_size"], a["num_local_experts"],
            a["num_experts_per_tok"], a["vocab_size"], a["rms_norm_eps"],
            a["rope_theta"], a["tie_word_embeddings"]) == (
        r["n_layers"], r["d_model"], r["n_heads"], r["n_kv_heads"],
        r["d_ff_expert"], r["n_experts"], r["top_k"], r["vocab_size"],
        r["norm_eps"], r["rope_theta"], r["tie_embeddings"])
    assert r["d_model"] // r["n_heads"] == r["head_dim"]
    w = json.loads((BASE / "configs" / "whisper-medium.json").read_text())
    a, r = w["as_run"], w["run"]
    assert (a["d_model"], a["encoder_layers"], a["decoder_layers"],
            a["encoder_attention_heads"], a["encoder_ffn_dim"],
            a["vocab_size"], a["max_source_positions"],
            a["tie_word_embeddings"]) == (
        r["d_model"], r["encoder_layers"], r["n_layers"], r["n_heads"],
        r["d_ff"], r["vocab_size"], r["encoder_seq"], r["tie_embeddings"])
    assert a["activation_function"] == "gelu_new" and r["act"] == "gelu"


def test_benchmark_json_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert list(spec) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert name.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (BASE / "cells" / f"{w['name']}.json").is_file()
        assert (BASE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert (BASE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("roofline"):
            assert m["unit"] == "%"
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file() and len(c["reduced"]) <= 16
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
