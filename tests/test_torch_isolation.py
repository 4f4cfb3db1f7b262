"""The port stands alone: nothing under ``src/repro_torch/`` (and not
``chip_smoke.py``) imports JAX or the reference package, ``triton`` is
imported only inside the functions that launch a kernel, a round of the
linear and of the real-model world runs with JAX absent from
``sys.modules``, and the default device is the card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node, node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    tree = ast.parse(path.read_text())
    for _, name in _imports(tree):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {name}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_triton_only_imported_inside_functions(path):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] == "triton" for n in names), \
                f"{path.relative_to(ROOT)} imports triton at module level"


def test_one_round_runs_without_jax():
    code = (
        "import sys\n"
        "from repro_torch.core.engine import RoundEngine, ServerConfig\n"
        "from repro_torch.fl.experiments import build_linear_setting\n"
        "import repro_torch.convert, repro_torch.kernels.batched_dot.ops\n"
        "tasks, B, avail = build_linear_setting()\n"
        "eng = RoundEngine(tasks, B, avail, ServerConfig(method='stalevre'),"
        " device='cpu')\n"
        "state, mets = eng.round_step(eng.init_state())\n"
        "assert state.round == 1 and mets['beta'].shape == (2, 16)\n"
        "from repro_torch.fl.experiments import build_model_setting\n"
        "tasks, B, avail = build_model_setting()\n"
        "eng = RoundEngine(tasks, B, avail, ServerConfig(method='stalevre',"
        " local_epochs=1, batch_size=4, active_rate=0.5), device='cpu')\n"
        "state, mets = eng.round_step(eng.init_state())\n"
        "assert state.round == 1 and mets['beta'].shape == (3, 8)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PORT.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_the_card(monkeypatch):
    """With no GPU, the default device raises instead of falling back to
    the CPU; ``device="cpu"`` is the explicit way there."""
    from repro_torch.core.engine import RoundEngine, ServerConfig
    from repro_torch.fl.experiments import (ExperimentSpec,
                                            build_linear_setting,
                                            run_experiment)
    assert ExperimentSpec().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tasks, B, avail = build_linear_setting()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RoundEngine(tasks, B, avail, ServerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment(ExperimentSpec(linear=True, n_models=2, n_clients=16,
                                      rounds=1))
    eng = RoundEngine(tasks, B, avail, ServerConfig(), device="cpu")
    assert eng.device.type == "cpu"


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Without a GPU, and alone in a directory, the smoke script exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, env=env,
                             timeout=120, cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
