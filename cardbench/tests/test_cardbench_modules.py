"""A configuration names its program module and its plain reference, and
the harness, the check and calibrate reach both through those names: a
reference whose KV layers are a subset of the model's is judged row for
row as the whole model is, a second program and reference join the
benchmark as new files alone, and a configuration without its ``program``
or ``reference`` key is refused."""
import dataclasses
import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from cardbench import check, harness
from cardbench.reference import transformer
from cardbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
KEPT = 1          # the KV layer the subset reference keeps, of the tiny 2


class _Subset(transformer.Reference):
    """The tiny model with only layer KEPT's K and V as KV; layer 0's pass
    through the context state as the state of a layer without KV
    would."""

    def context_kv(self, tokens):
        k, v = super().context_kv(tokens)
        return k[KEPT:], v[KEPT:], k[:KEPT], v[:KEPT]

    def decode(self, state, tokens):
        k, v, k0, v0 = state
        logits, dk, dv = super().decode(
            (torch.cat([k0, k]), torch.cat([v0, v])), tokens)
        return logits, dk[KEPT:], dv[KEPT:]


SUBSET = types.SimpleNamespace(Reference=_Subset,
                               kv_layers=lambda m: [KEPT],
                               step_flops=transformer.step_flops)


def _run(policy):
    run = harness.Run(tiny.cell(policy, max_new=8), 2 ** 31 + 404, "cpu",
                      time.perf_counter())
    run.setup()
    run.window(0.5, False)
    return run


def _judges(run, control):
    c = run.c
    st = [run.srv.contexts[cid] for cid in run.cids]
    full = [(s.exact_k[:, 0], s.exact_v[:, 0]) for s in st]
    args = (c.config["model"], c.config["sparkv"], run.params,
            run.traffic.contexts)
    return (check.Judge(transformer, *args, full, run.device,
                        control=control),
            check.Judge(SUBSET, *args, [(k[KEPT:], v[KEPT:])
                                        for k, v in full], run.device,
                        control=control))


def _kept(r):
    """The request as a program storing only layer KEPT's KV would give
    it: tail and assembled cache of that row, its streamed chunks."""
    assembled = r.assembled
    if assembled is not None:
        k, v, streamed = assembled
        assembled = (k[KEPT:], v[KEPT:],
                     [(t, l - KEPT) for t, l in streamed if l >= KEPT])
    return dataclasses.replace(r, tail=tuple(x[KEPT:] for x in r.tail),
                               assembled=assembled)


@pytest.mark.parametrize("control", [False, True])
def test_subset_of_kv_layers_reads_the_rows_of_the_whole(control):
    run = _run("local_prefill")
    full, sub = _judges(run, control)
    # the token errors of context 0: K of layers 0 and 1, then V
    whole, part = full.kv_token_errors(), sub.kv_token_errors()
    assert len(part) == 2
    assert torch.equal(part[0], whole[KEPT])
    assert torch.equal(part[1], whole[2 + KEPT])
    for r in run.requests:
        e_f, g_f, kv_f, a_f = full.request(r)
        e_s, g_s, kv_s, a_s = sub.request(_kept(r))
        assert torch.equal(kv_s, kv_f[:, KEPT:])
        # layer 0's KV reached the subset's decode untouched, as the state
        # of a layer without KV
        assert (e_s == e_f).all() and (g_s == g_f).all()
        assert (a_s == a_f).all()


def test_subset_of_kv_layers_reads_the_streamed_chunks_of_the_whole():
    run = _run("sparkv")
    full, sub = _judges(run, False)
    streaming = [r for r in run.requests if r.assembled is not None]
    assert streaming
    for r in streaming:
        whole = full.stream_gaps(r.context, r.assembled)
        part = sub.stream_gaps(r.context, _kept(r).assembled)
        assert part == {(i, t, l - KEPT): g
                        for (i, t, l), g in whole.items() if l >= KEPT}


def test_stored_rows_that_are_not_the_kv_layers_are_refused():
    run = _run("local_prefill")
    c = run.c
    st = run.srv.contexts[run.cids[0]]
    with pytest.raises(ValueError, match="KV layers"):
        check.Judge(SUBSET, c.config["model"], c.config["sparkv"],
                    run.params, run.traffic.contexts,
                    [(st.exact_k[:, 0], st.exact_v[:, 0])], run.device)


@pytest.mark.parametrize("key", ["program", "reference"])
def test_configuration_without_its_module_key_is_refused(key):
    c = tiny.cell()
    del c.config[key]
    with pytest.raises(KeyError, match=key):
        (harness.port_config if key == "program"
         else harness.reference_module)(c.config)
    if key == "program":
        with pytest.raises(KeyError, match=key):
            harness.Run(c, 5, "cpu", time.perf_counter()).setup()


@pytest.mark.parametrize("conf", [c["file"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]])
def test_configuration_names_modules_that_provide_the_interface(conf):
    cfg = json.loads((ROOT / conf).read_text())
    ref = harness.reference_module(cfg)
    assert callable(ref.Reference) and callable(ref.step_flops)
    layers = ref.kv_layers(cfg["model"])
    assert layers and layers == sorted(set(layers))
    model_cfg, spcfg = harness.port_config(cfg)
    assert model_cfg.name == cfg["name"]
    assert model_cfg.num_layers == cfg["model"]["num_layers"]
    assert spcfg.chunk_tokens == cfg["sparkv"]["chunk_tokens"]


# ------------------------------------------- a second program, new files
PROGRAM = '''"""A second program module: the transformer's, counted."""
from cardbench.programs import transformer

CALLS = []


def config(conf):
    CALLS.append(conf["name"])
    return transformer.config(conf)
'''

REFERENCE = '''"""A second reference module: the transformer's, counted."""
from cardbench.reference import transformer

CALLS = {"Reference": 0, "context_kv": 0, "decode": 0, "kv_layers": 0,
         "step_flops": 0}


class Reference(transformer.Reference):
    def __init__(self, *a, **kw):
        CALLS["Reference"] += 1
        super().__init__(*a, **kw)

    def context_kv(self, tokens):
        CALLS["context_kv"] += 1
        return super().context_kv(tokens)

    def decode(self, state, tokens):
        CALLS["decode"] += 1
        return super().decode(state, tokens)


def kv_layers(m):
    CALLS["kv_layers"] += 1
    return transformer.kv_layers(m)


def step_flops(m, kv_len):
    CALLS["step_flops"] += 1
    return transformer.step_flops(m, kv_len)
'''

DRIVE = '''
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import cardbench
assert cardbench.__file__.startswith({root!r}), cardbench.__file__
from cardbench import calibrate, check, harness
c = harness.cell("tiny-second.tiny-local", harness.ROOT)
run = harness.Run(c, 2 ** 31 + 505, "cpu", time.perf_counter())
run.setup()
run.window(0.5, False)
ok, rows = check.verdict(check.judge(run), c.limits)
calibrate.readings(run, False)
calibrate.readings(run, True)
ctx = run.context()
ctx.step_flops(ctx.model, 100)
p = sys.modules["cardbench.programs.second"]
r = sys.modules["cardbench.reference.second"]
print(json.dumps({{"ok": ok, "rows": rows, "program": p.CALLS,
                  "reference": r.CALLS, "requests": len(run.requests)}}))
'''


def test_second_program_and_reference_join_as_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "cardbench").rglob("*")
              if p.is_file()}
    here = tmp_path / "cardbench"
    (here / "programs" / "second.py").write_text(PROGRAM)
    (here / "reference" / "second.py").write_text(REFERENCE)
    conf = tiny.cell("local_prefill", max_new=8,
                     limits_of="granite-moe-3b-l2.govreport-decode")
    (here / "configs" / "tiny-second.json").write_text(json.dumps(
        {**conf.config, "name": "tiny-second", "program": "second",
         "reference": "second"}))
    (here / "traffic" / "tiny-local.json").write_text(
        json.dumps(conf.workload))
    (here / "limits" / "tiny-second.tiny-local.json").write_text(
        json.dumps({"cell": "tiny-second.tiny-local",
                    "limits": conf.limits}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-second", "source": "none",
                             "file": "cardbench/configs/tiny-second.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-second.tiny-local",
                               "config": "tiny-second",
                               "traffic": "tiny-local", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = DRIVE.format(root=str(tmp_path), src=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["ok"], out["rows"]
    assert out["requests"] >= 1
    assert out["program"] == ["tiny-second"]
    # the check ran twice and calibrate twice, once as the control
    calls = out["reference"]
    assert calls["Reference"] == 4 and calls["kv_layers"] == 3
    assert calls["context_kv"] == 4
    assert calls["decode"] == 4 * out["requests"]
    assert calls["step_flops"] == 1
    # no file the benchmark had was edited
    assert all(p.read_bytes() == b for p, b in before.items())


PROGRAMS = """
import json, pathlib, sys
sys.path[:0] = [{src!r}, {root!r}]
from cardbench import harness
for p in sorted(pathlib.Path({programs!r}).glob("*.py")):
    __import__("cardbench.programs." + p.stem)
for c in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["configs"]:
    harness.port_config(json.loads((harness.ROOT / c["file"]).read_text()))
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_program_modules_load_no_jax_nor_the_jax_package():
    """Each program module, and the program configurations it builds for
    every configuration, load the port and nothing of JAX."""
    code = PROGRAMS.format(src=str(ROOT / "src"), root=str(ROOT),
                           programs=str(ROOT / "cardbench" / "programs"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    mods = set(p.stdout.split())
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}
