"""The port's benchmark harness (``benchmarks_torch/``) beside the
reference's (``benchmarks/``): the registry, the copies, the results
guard, the device it runs on, and the one bench priced on the H100 model
(roofline).

A bench whose imports reach only the port's copied modules or its
predictor is kept as a *copy*: the reference's file with ``repro`` and
``benchmarks`` retargeted to ``repro_torch`` and ``benchmarks_torch`` in
its import lines only. The benches that import JAX (fig4, quality) and
roofline (which prices with the H100 model) are ports.
tests/test_torch_bench_parity*.py hold the harnesses' results equal.
"""
import ast
import glob
import json
import os
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import benchmarks.run as JRUN  # noqa: E402
import benchmarks_torch.common as common  # noqa: E402
import benchmarks_torch.run as TRUN  # noqa: E402
from benchmarks_torch import bench_roofline  # noqa: E402
from repro_torch.core import baselines as TB  # noqa: E402
from repro_torch.device import named, resolve  # noqa: E402
from repro_torch.distributed import roofline as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "benchmarks", ROOT / "benchmarks_torch"
PORTED = {"bench_fig4_entropy_codesize.py", "bench_quality_validation.py",
          "bench_roofline.py"}
COPIES = sorted(p.name for p in REF.glob("bench_*.py")
                if p.name not in PORTED)
RESULTS = sorted(glob.glob(os.path.join(
    os.path.normpath(common.RESULTS_DIR), "*.json")))


def test_registry_is_the_reference_registry():
    """The same names, in the same order, each a module of the port."""
    assert [n for n, _ in TRUN.BENCHES] == [n for n, _ in JRUN.BENCHES]
    assert len(TRUN.BENCHES) == 21
    for (_, jmod), (_, tmod) in zip(JRUN.BENCHES, TRUN.BENCHES):
        assert tmod == jmod.replace("benchmarks.", "benchmarks_torch.", 1)
        assert (ROOT / (tmod.replace(".", "/") + ".py")).exists()
    assert len(COPIES) == 18


@pytest.mark.parametrize("name", COPIES)
def test_copy_matches_reference(name):
    """A copy equals its reference once the port's names are read as the
    reference's, and every import of the reference's packages is
    retargeted."""
    ref = (REF / name).read_text()
    copy = (PORT / name).read_text()
    assert copy.replace("repro_torch", "repro").replace(
        "benchmarks_torch", "benchmarks") == ref
    assert not re.search(r"^\s*(from|import)\s+(repro|benchmarks)\b(?!_)",
                         copy, re.M)
    assert "jax" not in copy


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ports_keep_the_reference_save_names(name):
    """Each port saves under its reference's name."""
    assert _save_names(PORT / name) == _save_names(REF / name)


def _save_names(path) -> set:
    """String literals reachable as the first argument of ``save(...)``
    (the leftmost constant of a computed name)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else \
            fn.attr if isinstance(fn, ast.Attribute) else None
        if name != "save":
            continue
        for sub in ast.walk(node.args[0]):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                names.add(sub.value)
                break
    return names


def _registered_save_names() -> set:
    return set().union(*(_save_names(ROOT / (m.replace(".", "/") + ".py"))
                         for _, m in TRUN.BENCHES))


# ---------------------------------------------------------------------------
# results guard (the port of tests/test_benchmark_guard.py)
# ---------------------------------------------------------------------------


def test_quick_save_routes_to_quick_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(common, "QUICK_DIR", str(tmp_path / "quick"))
    with named("cpu"):
        full = common.save("x", {"rows": [1]})
        quick = common.save("x", {"rows": [1]}, quick=True)
        assert os.path.normpath(full) != os.path.normpath(quick)
        assert os.sep + "quick" + os.sep in quick
        before = os.path.getmtime(full)
        common.save("x", {"rows": [2]}, quick=True)
    assert os.path.getmtime(full) == before
    with open(quick) as f:
        assert json.load(f)["_device"] == "cpu"


def test_results_live_beside_the_reference_and_quick_is_ignored():
    results = os.path.normpath(common.RESULTS_DIR)
    assert results == str(ROOT / "results" / "benchmarks_torch")
    assert os.path.normpath(common.QUICK_DIR).startswith(results)
    with open(ROOT / ".gitignore") as f:
        assert "results/benchmarks_torch/quick/" in f.read().split("\n")


def test_every_bench_threads_quick_through_save():
    offenders = []
    for path in sorted(PORT.glob("bench_*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "save"
                    and not any(kw.arg == "quick" for kw in node.keywords)):
                offenders.append(f"{path.name}:{node.lineno}")
    assert not offenders


def test_profile_stamp_routes_through_save(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(common, "PROFILE", True)
    with named("cpu"):
        common.begin_bench()
        path = common.save("x", {"rows": [1]})
    with open(path) as f:
        block = json.load(f)["_profile"]
    assert block["bench_wall_s"] >= 0
    assert "sim_events" in block and "sim_events_per_s" in block


def test_checked_in_results_validate_against_the_registry():
    """Every JSON in results/benchmarks_torch/ (none is checked in yet)
    is a full run of a registered bench, stamped with its name and
    device."""
    names = _registered_save_names()
    for path in RESULTS:
        with open(path) as f:
            payload = json.load(f)
        fname = os.path.splitext(os.path.basename(path))[0]
        assert payload["_bench"] == fname and "_device" in payload
        assert not payload.get("_quick", False), fname
        assert any(fname == n or fname.startswith(n) for n in names), fname


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------


def test_named_device_reaches_the_planner_cache(monkeypatch):
    """``--device cpu`` reaches the copied planner cache, which builds its
    LatencyPredictor with no device: inside ``named`` it lands there;
    outside, it asks for the card (and raises without one)."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke("sparkv-qwen3-4b")
    monkeypatch.setattr(TB, "_PRED_CACHE", {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TB._predictor_cache(cfg, "jetson-orin")
    with named("cpu") as dev:
        assert dev == torch.device("cpu") and resolve() == dev
        pred = TB._predictor_cache(cfg, "jetson-orin")
    assert pred.device == torch.device("cpu")
    assert pred.params[0]["w"].device.type == "cpu"


def test_named_nests_and_unwinds():
    with named("cpu"):
        with named("meta"):
            assert resolve() == torch.device("meta")
        assert resolve() == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve()
        with pytest.raises(RuntimeError):
            with named("cuda"):
                pass


def test_run_cli_names_its_device(tmp_path, monkeypatch, capsys):
    """--device cpu runs a bench on the CPU and stamps it; without a card
    the default device raises before any bench runs; unknown names are
    refused."""
    monkeypatch.setattr(common, "QUICK_DIR", str(tmp_path))
    TRUN.main(["--quick", "--only", "fig3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "fig3" in out
    with open(tmp_path / "fig3_chunk_latency.json") as f:
        assert json.load(f)["_device"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TRUN.main(["--quick", "--only", "fig3"])
    with pytest.raises(SystemExit):
        TRUN.main(["--quick", "--only", "fig99", "--device", "cpu"])


# ---------------------------------------------------------------------------
# roofline: the dry run's records priced on the H100 model
# ---------------------------------------------------------------------------

MESHES = ["pod16x16", "pod2x16x16"]


@pytest.mark.parametrize("mesh", MESHES)
def test_roofline_rows_hold_the_h100_model_terms(mesh, tmp_path,
                                                 monkeypatch):
    """Every OK record of results/dryrun_torch/ becomes a row whose terms
    are roofline.roofline_terms of its own flops, analytic bytes and
    collectives by link, and whose bound is the largest term; the table
    has rows (the reference's bench has none without results/dryrun/)."""
    monkeypatch.setattr(common, "QUICK_DIR", str(tmp_path))
    with named("cpu"):
        rows = bench_roofline.run(quick=True, mesh_tag=mesh)
    recs = {}
    for path in sorted((ROOT / "results" / "dryrun_torch" / mesh)
                       .glob("*.json")):
        rec = json.loads(path.read_text())
        recs[(rec["arch"], rec["shape"])] = rec
    assert len(rows) == len(recs) and rows
    ok = [r for r in rows if r["status"] == "OK"]
    assert len(ok) == 32
    for row in ok:
        rec = recs[(row["arch"], row["shape"])]
        coll = rec["collectives"]["by_link"]
        flops = rec["cost"]["flops_per_dev"]
        assert row["compute_ms"] == pytest.approx(
            flops / R.PEAK_FLOPS * 1e3, rel=1e-12)
        assert row["memory_ms"] == pytest.approx(
            rec["cost"]["analytic_bytes_per_dev"] / R.HBM_BW * 1e3,
            rel=1e-12)
        assert row["collective_ms"] == pytest.approx(
            (coll["nvlink"] / R.NVLINK_BW + coll["nic"] / R.NIC_BW) * 1e3,
            rel=1e-12)
        terms = {"compute": row["compute_ms"], "memory": row["memory_ms"],
                 "collective": row["collective_ms"]}
        assert row["dominant"] == max(terms, key=terms.get)
        assert row["bound_ms"] == max(terms.values())
        assert row["useful_ratio"] == pytest.approx(
            rec["model_flops"] / (flops * rec["chips"]))
    with open(tmp_path / f"roofline_{mesh}.json") as f:
        assert json.load(f)["rows"] == json.loads(json.dumps(rows))
