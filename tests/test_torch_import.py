"""The port stands alone: no file under ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or ``repro``; every module imports with
``jax`` blocked; and without CUDA the entry points raise instead of
running on the CPU unless the caller asks for it."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {name}"


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "repro_torch.serve.engine" in mods and len(mods) > 20
    for m in ("repro_torch.kernels.quant4", "repro_torch.kernels.fused_compress",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.ref", "repro_torch.core.compression",
              "repro_torch.core.diloco", "repro_torch.core.adaptive",
              "repro_torch.optim.adamw", "repro_torch.optim.nesterov",
              "repro_torch.optim.schedules", "repro_torch.data.synthetic",
              "repro_torch.train.trainer", "repro_torch.train.quickstart",
              "repro_torch.tree", "repro_torch.kernels.lowrank_mm",
              "repro_torch.core.mesh_compression",
              "repro_torch.launch.steps", "repro_torch.launch.mesh",
              "repro_torch.launch.train", "repro_torch.launch.dryrun",
              "repro_torch.parallel.pipeline",
              "repro_torch.parallel.inner_engine",
              "repro_torch.parallel.sharding",
              "repro_torch.parallel.tensor", "repro_torch.core.comm",
              "repro_torch.core.membership", "repro_torch.topology",
              "repro_torch.topology.graphs", "repro_torch.topology.accounting",
              "repro_torch.topology.mixing", "repro_torch.sim",
              "repro_torch.sim.faults", "repro_torch.sim.timeline",
              "repro_torch.sim.engine", "repro_torch.sim.scenario",
              "repro_torch.sim.quadratic", "repro_torch.sim.problems",
              "repro_torch.sim.simulator"):
        assert m in mods, m
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from repro_torch.sim import (AsyncCommit, BoundedStaleEngine,\n"
            "                             async_modeled_times)\n"
            "from repro_torch.sim.simulator import _AsyncNumeric\n"
            "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is legitimate here")
    from repro_torch.configs.base import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve, train
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import quickstart, trainer

    cfg = get_config("opt-1.3b").reduced()
    params = M.init_params(cfg, torch.Generator(), torch.device("cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(params, cfg, max_seqs=1, page_size=4, n_pages=2,
                    max_pages_per_seq=2)
    for run in (trainer.run_diloco_training, trainer.run_allreduce_training,
                trainer.run_compressed_ddp_training):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(cfg, trainer.TrainConfig(), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "opt-1.3b", "--smoke", "--devices", "1",
                    "--clusters", "1", "--data", "1", "--model", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "opt-1.3b", "--smoke", "--paged"])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_cpu_engine_refuses_params_elsewhere():
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("opt-1.3b").reduced()
    params = M.init_params(cfg, device="meta")
    with pytest.raises(ValueError, match="params are on"):
        ServeEngine(params, cfg, max_seqs=1, page_size=4, n_pages=2,
                    max_pages_per_seq=2, device="cpu")


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line with no GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
