"""The port's examples (``examples_torch/``) on the CPU: the copies against
their references, the runner, the device each entry point asks for,
train_lm at a smoke size (the loss improves; a run with an injected
failure and a restart from the last commit logs the uninterrupted run's
losses, bit for bit), and elastic_rescale on one rank and on four gloo
ranks started as torchrun starts them (every rank exits 0, the loss goes
on improving, the resharded state equals the checkpoint on every rank,
and rank 0 alone wrote the step directories). The printed output of the
copies and quickstart is held to the reference's in
tests/test_torch_examples_parity.py.
"""
import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import examples_torch.run as RUN  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "examples", ROOT / "examples_torch"
COPIES = ("serve_fleet.py", "serve_under_volatility.py")
PORTED = ("quickstart.py", "train_lm.py", "elastic_rescale.py")
TIMEOUT = 300


def test_every_reference_example_has_its_counterpart():
    names = sorted(p.name for p in REF.glob("*.py"))
    assert names == sorted(COPIES + PORTED)
    assert sorted(f"{n}.py" for n in RUN.EXAMPLES) == names
    for n in names:
        assert (PORT / n).exists()


@pytest.mark.parametrize("name", COPIES)
def test_copy_matches_reference(name):
    """A copy equals its reference once the port's name is read as the
    reference's, and every import of the reference's package is
    retargeted."""
    ref = (REF / name).read_text()
    copy = (PORT / name).read_text()
    assert copy.replace("repro_torch", "repro") == ref
    assert not re.search(r"^\s*(from|import)\s+repro\b(?!_)", copy, re.M)
    assert "jax" not in copy
    changed = [(a, b) for a, b in zip(ref.splitlines(), copy.splitlines())
               if a != b]
    assert changed and all(re.match(r"(from|import) repro", a)
                           for a, _ in changed)


def test_runner_refuses_an_unknown_name():
    with pytest.raises(SystemExit) as e:
        RUN.main(["nope", "--device", "cpu"])
    assert e.value.code != 0
    for name in RUN.EXAMPLES:
        assert name in str(e.value.code)


def test_runner_runs_quickstart_on_the_named_device():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        RUN.main(["quickstart", "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("context: 512 tokens -> 32 KV chunks")
    assert [ln.split()[0] for ln in lines[1:]] == ["sparkv", "local_prefill",
                                                  "cachegen"]
    assert "fidelity=1.00" in lines[2]


@pytest.mark.parametrize("name", RUN.EXAMPLES)
def test_entry_points_ask_for_the_card(name, monkeypatch, tmp_path):
    """Without a card, every example raises unless the CPU is named: through
    the runner, and on its own (the copies build the planner on the
    default device, the card)."""
    import repro_torch.core.baselines as tb
    from repro_torch.device import resolve
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
        return
    monkeypatch.setattr(tb, "_PRED_CACHE", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RUN.main([name])
    if name in ("serve_fleet", "serve_under_volatility"):
        import runpy
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runpy.run_path(str(PORT / f"{name}.py"), run_name="__main__")
        return
    import importlib
    mod = importlib.import_module(f"examples_torch.{name}")
    kw = {} if name == "quickstart" else {"ckpt_dir": str(tmp_path)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([], **kw)


# ------------------------------------------------------------- train_lm

def _smoke_train(steps, fail_at, tmp_path):
    from repro_torch.configs import TrainConfig, get_smoke

    import examples_torch.train_lm as T
    argv = ["--device", "cpu", "--steps", str(steps), "--batch", "2",
            "--seq", "32"]
    if fail_at is not None:
        argv += ["--fail-at", str(fail_at)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = T.main(argv, cfg=get_smoke("qwen2.5-3b"),
                     tcfg=TrainConfig(learning_rate=2e-3, total_steps=steps,
                                      warmup_steps=3, checkpoint_every=5,
                                      seed=0),
                     ckpt_dir=str(tmp_path / f"ckpt-{fail_at}"))
    return out, buf.getvalue()


def test_train_lm_restart_logs_the_uninterrupted_losses(tmp_path):
    steps = 30
    clean, text = _smoke_train(steps, None, tmp_path)
    assert clean["restarts"] == 0 and clean["start"] == 0
    assert [s for s, _ in clean["history"]] == [9, 19, 29]
    assert clean["final_loss"] < clean["history"][0][1]
    assert "[improved]" in text
    # a failure at step 12: the supervisor restarts from the last commit
    # (step 10, or 5 while 10's write is in flight)
    hurt, text = _smoke_train(steps, 12, tmp_path)
    assert hurt["restarts"] == 1 and "[supervisor] injected node failure " \
        "at step 12" in text
    assert hurt["start"] in (5, 10)
    n = len(hurt["history"])
    assert n >= 2 and hurt["history"] == clean["history"][-n:]
    assert hurt["final_loss"] == clean["final_loss"]
    assert "[improved]" in text


# ------------------------------------------------------ elastic_rescale

BLOCK = '''
import sys
BLOCKED = ("jax", "jaxlib", "repro")
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
'''

RANK_SCRIPT = BLOCK + '''
import json, os
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.tree import leaves
import examples_torch.elastic_rescale as E

out_dir = sys.argv[1]
rank = int(os.environ.get("RANK", 0))
write = CheckpointManager._write

def logged(self, leaves_, treedef, step):
    with open(os.path.join(out_dir, f"writes.{rank}"), "a") as f:
        f.write(f"{step}\\n")
    return write(self, leaves_, treedef, step)

CheckpointManager._write = logged
cpu = torch.device("cpu")
started = E.start_group(cpu)
ckpt = os.path.join(out_dir, "ckpt")
res = E.main(["--device", "cpu"], ckpt_dir=ckpt)
state = res["state"]
stored = CheckpointManager(ckpt).restore(res["step"], like=state,
                                         device="cpu")
equal, sharded = [], 0
for x, want in zip(leaves(state), leaves(stored)):
    equal.append(bool(torch.equal(x.full_tensor(), want)))
    sharded += tuple(x.to_local().shape) != tuple(x.shape)
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump({"world": dist.get_world_size(),
               "backend": dist.get_backend(),
               "phase1": res["phase1"]["final_loss"],
               "phase3": res["phase3"]["final_loss"],
               "history3": res["phase3"]["history"],
               "start3": res["phase3"]["start"],
               "step": res["step"], "equal": equal, "sharded": sharded,
               "mesh": list(res["mesh"].shape)}, f)
if started:
    dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world, tmp_path, *, torchrun_env=True):
    """`world` ranks of the rank script, each given the environment
    torchrun gives its workers (or none: one rank alone); every rank's
    result."""
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    if torchrun_env:
        env.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(tmp_path)], cwd=ROOT,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)) if torchrun_env
        else env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        rcs = [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, rc in enumerate(rcs) if rc]
    assert not bad, (rcs, (tmp_path / f"rank{bad[0]}.log").read_text()[-4000:])
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]


def _check_rescale(res, world, tmp_path):
    for r in res:
        assert r["world"] == world and r["backend"] == "gloo"
        assert r["mesh"] == [world, 1] and r["step"] == 20
        assert r["phase3"] < r["phase1"]
        # phase 3 resumed from the commit phase 1 left
        assert r["start3"] == 20
        assert [s for s, _ in r["history3"]] == [24, 29, 34, 39]
        assert r["equal"] and all(r["equal"])
    # every rank trained the same unsharded state
    assert len({(r["phase1"], r["phase3"]) for r in res}) == 1
    # rank 0 alone wrote the step directories: 10 and 20 (twice: the
    # periodic save and the last), then 30 and 40 (twice)
    writers = sorted(p.name for p in tmp_path.glob("writes.*"))
    assert writers == ["writes.0"]
    steps = (tmp_path / "writes.0").read_text().split()
    assert steps == ["10", "20", "20", "30", "40", "40"]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["step-20", "step-30", "step-40"]


def test_elastic_rescale_on_four_gloo_ranks(tmp_path):
    res = _run_ranks(4, tmp_path)
    _check_rescale(res, 4, tmp_path)
    # on a (4, 1) mesh the resharding is real: some leaves are split
    assert all(r["sharded"] > 0 for r in res)


def test_elastic_rescale_alone_starts_one_rank(tmp_path):
    res = _run_ranks(1, tmp_path, torchrun_env=False)
    _check_rescale(res, 1, tmp_path)
    assert res[0]["sharded"] == 0
