"""BENCHMARK.json resolves to the benchmark's files and keeps the
format: names, units, keys, bounds, the metrics a cell reports."""
import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "cardbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
WIDTHS = ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
          "vocab_size", "moe")


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert BENCH["paths"] == ["cardbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_lines(section):
    names = set()
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        assert e["name"] not in names
        names.add(e["name"])
        for k in ("why", "layer", "source"):
            if k in e:
                assert _one_line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metric_names_unique_across_sections():
    assert len(METRICS) == len(set(METRICS))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert w["chips"] == 1
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    assert traffic["context_tokens"] > 0
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    assert limits["cell"] == cell and limits["limits"]
    # prompt + answer stays inside the decode tail buffer (128)
    assert max(traffic["prompt_lengths"]) + traffic["max_new"] <= 128


def test_each_pair_of_config_and_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_config_resolves_and_reduces_depth_only(conf):
    e = next(c for c in BENCH["configs"] if c["name"] == conf)
    assert e["file"].startswith("cardbench/configs/")
    cfg = json.loads((ROOT / e["file"]).read_text())
    assert cfg["name"] == conf and cfg["source"] == e["source"]
    assert sorted(cfg["reduced"]) == sorted(e["reduced"])
    assert not set(e["reduced"]) & set(WIDTHS)
    for k, (was, now) in cfg["reduced"].items():
        assert cfg["model"][k] == now != was
    assert (HERE / "reference" / f"{cfg['reference']}.py").exists()
    assert any(w["config"] == conf for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(e["file"]) == 1


@pytest.mark.parametrize("metric", METRICS)
def test_metric_has_a_reader(metric):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {
        "ttft_ms", "tpot_ms", "requests_per_s", "setup_s"}


def _reports(metric, cell):
    return cell in metric.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, cell) for m in BENCH["per_layer"])


def test_per_layer_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        for cell in m["workloads"]:
            assert _reports(e2e[m["moves"]], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(_one_line(k) for k in layers)


def test_rooflines_and_mfu_are_shares():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


@pytest.mark.parametrize("traffic", sorted({w["traffic"]
                                            for w in BENCH["workloads"]}))
def test_traffic_names_its_source_and_what_it_assumes(traffic):
    t = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    assert t["name"] == traffic
    assert t["source"] and t["assumed"]
    # the server registers whole chunks of the configurations' 1024 tokens
    assert t["context_tokens"] % 1024 == 0
    assert t["policy"] in ("sparkv", "local_prefill")
