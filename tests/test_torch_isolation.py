"""The port stands alone: no module of src/repro_torch, and neither
chip_smoke.py nor the scripts under tools/, imports jax or anything of
the reference package; and its entry points run on the GPU unless asked
for the CPU."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.core.protocols import FederatedConfig, FederatedTrainer
from repro_torch.data import synthetic_images, synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.models import CNN
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import init_params

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_the_walk_sees_the_package():
    assert len(FILES) > 20
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/core/graphs.py",
            "src/repro_torch/core/conversion.py",
            "tools/round_ab.py"} <= names


def test_entry_points_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(CNN(), FederatedConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_images(rng.PRNGKey(0), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_tokens(rng.PRNGKey(1), 2, 8, 512)
    cfg = get_config("qwen2-0.5b-smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, rng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("qwen2-0.5b", 2, 8, 2)
    ssm = get_config("mamba2-370m-smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(ssm, rng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(ssm, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("mamba2-370m", 2, 8, 2)
    assert resolve_device("cpu") == torch.device("cpu")
