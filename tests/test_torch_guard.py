"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_smoke_config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
#: the card's machine has neither JAX nor ml_dtypes
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = sorted(n for n in _imported(path)
                 if n.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_cpu_serve_smoke_loads_neither_jax_nor_reference():
    code = (
        "import sys, runpy\n"
        "sys.argv = ['serve', '--arch', 'smollm-360m', '--smoke', "
        "'--device', 'cpu', '--batch', '1', '--prompt-len', '6', "
        "'--gen', '3']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "import repro_torch.weights, repro_torch.core.integrity\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print('LOADED', loaded)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "generated (1, 3)" in res.stdout
    assert "LOADED []" in res.stdout, res.stdout


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    from repro_torch.launch.serve import Server
    from repro_torch.models.api import build
    from repro_torch.weights import from_jax_params
    cfg = get_smoke_config("smollm-360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"layers": {}}, cfg)
    with pytest.raises(RuntimeError):
        build(cfg).init(0, device="cuda")


@pytest.mark.parametrize("where", ["alone", "in_checkout"])
def test_chip_smoke_refuses_without_a_card(tmp_path, where):
    """Alone in a directory, or on a machine without a card, the smoke
    script exits non-zero and prints no result."""
    if where == "in_checkout" and torch.cuda.is_available():
        pytest.skip("a card is present")
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=script.parent, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
