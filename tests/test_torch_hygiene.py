"""Import hygiene of the port: nothing under ``src/repro_torch/`` and
nothing in ``chip_smoke.py`` imports JAX or the reference package
(``repro``); the launcher imports without pulling JAX in; and the entry
points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_launcher_import_leaves_jax_out():
    code = ("import sys, repro_torch.launch.serve_cnn, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from repro_torch.core import workload as Wt
    from repro_torch.core.program import compile_model
    from repro_torch.models import cnn
    from repro_torch.serving.server import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = Wt.CNN_MODELS["alexnet"]()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_model(m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_model(m, cnn.init_params_np(m), calib_batch=np.zeros(
            (1, 227, 227, 3), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("alexnet", frames=8, batch=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cnn.init_params(m)
    assert compile_model(m, device="cpu").device.type == "cpu"
