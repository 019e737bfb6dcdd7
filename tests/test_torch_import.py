"""The port stands alone: every ``repro_torch`` module imports with JAX
(and ml_dtypes) blocked, and no file of the port (or ``chip_smoke.py``)
imports ``jax``, ``ml_dtypes`` or anything of the ``repro`` package."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    import repro_torch
    return sorted(["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")])


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert "repro_torch.serve.engine" in mods and "repro_torch.kernels.ops" in mods
    assert {"repro_torch.train.step", "repro_torch.optim.adamw", "repro_torch.core.schedule",
            "repro_torch.launch.train", "repro_torch.kernels.swiglu",
            "repro_torch.models.ssm", "repro_torch.kernels.ssd",
            "repro_torch.launch.mesh", "repro_torch.parallel.comm",
            "repro_torch.parallel.sharding", "repro_torch.parallel.specs",
            "repro_torch.core.overlap", "repro_torch.kernels.ring_matmul",
            "repro_torch.core.quant", "repro_torch.checkpoint.wire",
            "repro_torch.checkpoint.manager", "repro_torch.checkpoint.grid",
            "repro_torch.runtime.guard", "repro_torch.runtime.fault",
            "repro_torch.runtime.procs", "repro_torch.parallel.megatron",
            "repro_torch.parallel.pipeline", "repro_torch.configs.minicpm3_4b",
            "repro_torch.kernels.flash_attention"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules\n"
            "               if sys.modules[k] is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, (path, roots)


def test_checkpoint_modules_are_scanned():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"checkpoint/wire.py", "checkpoint/manager.py", "checkpoint/grid.py",
            "runtime/guard.py", "runtime/fault.py", "runtime/procs.py",
            "parallel/megatron.py", "parallel/pipeline.py", "configs/minicpm3_4b.py",
            "kernels/flash_attention.py"} <= scanned
