"""The port stands alone: it imports with JAX and the JAX package blocked,
no file of it (nor chip_smoke.py) imports either, and its entry points
ask for the card unless told to use the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BLOCKED = ("jax", "jaxlib", "repro")


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _blocked(name: str) -> bool:
    """`repro` and `repro.*` exactly (not `repro_torch`), jax, jaxlib."""
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_port_imports_with_jax_and_reference_blocked():
    mods = _port_modules()
    assert {"repro_torch.kernels.kv_dequant.kernel",
            "repro_torch.models.ssm", "repro_torch.models.mamba_lm",
            "repro_torch.models.hybrid", "repro_torch.models.encdec",
            "repro_torch.training.optimizer",
            "repro_torch.training.trainer",
            "repro_torch.training.compression",
            "repro_torch.checkpoint.manager",
            "repro_torch.launch.train"} <= set(mods)
    code = f"""
import sys
BLOCKED = {BLOCKED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import importlib
for m in {mods!r}:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not bad, bad
print("ok", len({mods!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        assert not any(_blocked(n) for n in names), (path, names)


def test_blocker_lets_the_port_through():
    assert _blocked("repro") and _blocked("repro.core.engine")
    assert _blocked("jax.numpy") and not _blocked("repro_torch.core")
    assert not _blocked("jaxtyping")


def test_default_device_is_the_card():
    """With no card here, every entry point raises unless given 'cpu'."""
    from repro_torch.configs import SparKVConfig, get_smoke
    from repro_torch.device import resolve
    from repro_torch.models import build_model
    from repro_torch.serving.engine import SparKVServer
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve()
    with pytest.raises(RuntimeError):
        resolve("cuda")
    assert resolve("cpu") == torch.device("cpu")
    model = build_model(get_smoke("sparkv-qwen3-4b"))
    with pytest.raises(RuntimeError):
        model.init(0)
    params = model.init(0, device="cpu")
    assert params["emb"].device.type == "cpu"
    with pytest.raises(RuntimeError):
        SparKVServer(model, params, SparKVConfig())
    srv = SparKVServer(model, params, SparKVConfig(), device="cpu")
    assert srv.device.type == "cpu"
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError):
        main(["--requests", "1"])


def test_chip_smoke_refuses_without_its_checkout(tmp_path):
    """Alone in a directory, chip_smoke.py exits non-zero, prints no
    result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
