"""The port stands alone: no module of src/repro_torch, and neither
chip_smoke.py, the scripts under tools/ nor the port's examples
(examples/torch_*.py), imports jax, anything of the reference package
or the reference's benchmark harness; only the channel package reaches
the raw channel model (``repro_torch.channel.model``), everything else
goes through the link pipeline (the reference's ruff TID251 ban, as a
test); and its entry points run on the GPU unless asked for the CPU."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.core.protocols import FederatedConfig, FederatedTrainer
from repro_torch.data import (parse_task, synthetic_audio, synthetic_images,
                              synthetic_rgb_images, synthetic_tokens)
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve, serve_classifier
from repro_torch.launch.mesh import (make_device_mesh, make_grid_mesh,
                                     make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.service import FederatedService, InferenceEndpoint
from repro_torch.launch.train import main as train_main
from repro_torch.models import CNN
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import init_params

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")) + \
    sorted((ROOT / "examples").glob("torch_*.py"))


def _imports(path, resolve=False):
    """The absolute names a file imports (with ``resolve``, relative
    imports too, resolved against the file's package, and each imported
    name as a submodule candidate)."""
    package = []
    if resolve and ROOT / "src" in path.parents:
        package = list(path.relative_to(ROOT / "src").parent.parts)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module
            elif not resolve:
                continue
            else:
                up = package[:len(package) - node.level + 1]
                base = ".".join(up + ([node.module] if node.module else []))
            yield base
            if resolve:
                yield from (f"{base}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "benchmarks"), (path,
                                                                     name)


@pytest.mark.parametrize("path", [
    p for p in FILES if ROOT / "src" / "repro_torch" / "channel"
    not in p.parents], ids=lambda p: str(p.relative_to(ROOT)))
def test_only_the_channel_package_imports_the_channel_model(path):
    for name in _imports(path, resolve=True):
        assert not name.startswith("repro_torch.channel.model"), (path,
                                                                   name)


def test_the_walk_sees_the_package():
    assert len(FILES) > 20
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/core/graphs.py",
            "src/repro_torch/core/conversion.py",
            "src/repro_torch/core/sampling.py",
            "src/repro_torch/core/privacy.py",
            "src/repro_torch/models/registry.py",
            "src/repro_torch/data/partition.py",
            "src/repro_torch/core/program.py",
            "src/repro_torch/checkpoint/__init__.py",
            "src/repro_torch/launch/service.py",
            "src/repro_torch/sweep/__init__.py",
            "src/repro_torch/sweep/axes.py",
            "src/repro_torch/sweep/engine.py",
            "src/repro_torch/sweep/results.py",
            "src/repro_torch/optim/__init__.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/steps.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/configs/qwen2_moe_a2_7b.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/sharding.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/roofline/analysis.py",
            "tools/round_ab.py",
            "examples/torch_quickstart.py",
            "examples/torch_paper_fig2.py",
            "examples/torch_serve_batched.py",
            "examples/torch_train_lm_mix2fld.py"} <= names
    # the import walk resolves relative imports: the pipeline's own
    # import of the channel model is seen
    assert "repro_torch.channel.model.round_trip_traced" in set(_imports(
        ROOT / "src" / "repro_torch" / "channel" / "pipeline.py",
        resolve=True))


def test_entry_points_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(CNN(), FederatedConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_images(rng.PRNGKey(0), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(None, FederatedConfig(model="mlp", task="speech"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(None, FederatedConfig(model="cnn+mlp",
                                               protocol="fd"))
    for make in (synthetic_rgb_images, synthetic_audio,
                 parse_task("cifar").data):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(rng.PRNGKey(0), 4)
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
    for arch in ("qwen3-14b", "h2o-danube-3-4b", "qwen2-moe-a2.7b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve(arch, 2, 8, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_cache(get_config(arch + "-smoke"), 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedService(CNN(), FederatedConfig(num_devices=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEndpoint(CNN().apply)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_classifier("cnn", "digits", 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(None, FederatedConfig(model="transformer"))
    for mode in ("paper", "lm"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(["--mode", mode])
    # the sharded path and its meshes (A13): no group starts without a
    # device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(CNN(), FederatedConfig(shard_devices=True))
    for make in (lambda: make_device_mesh(4), lambda: make_grid_mesh(2, 4),
                 lambda: make_mesh((1,), ("pod",)), make_host_mesh,
                 make_production_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
