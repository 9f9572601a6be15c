"""The port's dry run (``launch/dryrun.py``) and the sharding rules on
DTensors, each run in a process of its own: a fake world of 512 ranks
(the dry run), or a one-rank gloo group (the host mesh), never this
process's default group, which other test files of a worker use.

* The CLI at the published widths (qwen2-0.5b, prefill_32k, 16 x 16)
  writes an ``ok`` record with every top-level key of the reference's
  record (read from its source: it cannot lower for 512 chips here),
  the per-rank argument bytes that the rules' specs give, and the H100
  roofline terms; nothing under ``benchmarks/``.
* ``to_placements`` of ``("pod", "data")`` on a fake (2, 16, 16) mesh:
  each rank's block is the reference's (pod-major rows), and back; the
  sync steps of the qwen2-0.5b smoke config on that mesh: the FD sync's
  cross-pod bytes are its uplink table, fewer than the FL sync's.
* The serve on the (1, 1) host mesh, parameters, prompts and cache placed
  by the rules and the hook installed, gives the plain serve's tokens bit
  for bit (the CPU rehearsal of ``chip_smoke.py`` phase 49).
"""
import ast
import inspect
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

from repro_torch import configs
from repro_torch.launch import dryrun, sharding as shp
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.roofline import analysis
from test_torch_reference import load_reference

ROOT = Path(__file__).resolve().parents[1]


def _run(code: str, *args, timeout=300) -> dict:
    """``code`` in a new Python process (one intra-op thread); the JSON
    of its last line of output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          *map(str, args)], capture_output=True, text=True,
                         env=env, timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _reference_record_keys() -> set:
    """The top-level keys of the reference's ``ok`` record."""
    src = inspect.getsource(load_reference().dryrun.dry_run_combo)
    keys = {"arch", "shape", "mesh", "status"}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  "") == "update":
            keys |= {k.value for k in node.args[0].keys}
    return keys


class _Mesh16:
    mesh_dim_names = ("data", "model")
    shape = (16, 16)


def _rank_bytes(tree, specs) -> int:
    """Rank 0's bytes of ``tree`` placed by ``specs``: each dim divided
    by the sizes of the mesh dims its entry names (the rules' specs are
    sanitized: they divide)."""
    sizes = dict(zip(_Mesh16.mesh_dim_names, _Mesh16.shape))
    total = 0
    for path, t in _leaves(tree):
        spec = _at(specs, path)
        n = math.prod(t.shape)
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n //= sizes[a]
        total += n * t.element_size()
    return total


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_cli_writes_an_ok_record(tmp_path):
    before = sorted((ROOT / "benchmarks").rglob("*"))
    rec = _run("""
        import json, sys
        from repro_torch.launch import dryrun
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "prefill_32k",
                     "--out", sys.argv[1]])
        print(json.dumps(json.load(open(
            sys.argv[1] + "/qwen2-0.5b_prefill_32k_16x16.json"))))
        """, tmp_path)
    assert sorted((ROOT / "benchmarks").rglob("*")) == before
    assert rec["status"] == "ok", rec.get("error")
    assert _reference_record_keys() <= set(rec)
    assert rec["chips"] == 256 and rec["decode_tp"] is False
    cfg = configs.get_config("qwen2-0.5b")
    params = dryrun.param_specs(cfg)
    specs = configs.input_specs(cfg, "prefill_32k")
    want = (_rank_bytes(params, shp.param_pspecs(cfg, _Mesh16, params))
            + _rank_bytes(specs, shp.batch_pspecs(cfg, _Mesh16, specs)))
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["memtracker_peak_bytes"] >= want
    coll = rec["collective_breakdown"]
    assert rec["collective_bytes_per_device"] == sum(
        coll[k] for k in analysis.COLLECTIVES) > 0
    assert rec["cross_pod_bytes_per_device"] == 0
    af = analysis.analytic_flops(cfg, configs.INPUT_SHAPES["prefill_32k"],
                                 dryrun.active_count_from_specs(cfg, params))
    assert rec["analytic_flops_total"] == af
    assert rec["roofline"] == analysis.roofline_terms(
        af / 256, rec["hbm_traffic_model_bytes"],
        rec["collective_bytes_per_device"], 256, PEAK_FLOPS_BF16, HBM_BW,
        NVLINK_BW)
    assert rec["model_flops_total"] == dryrun.model_flops(cfg, params,
                                                          "prefill_32k")
    assert rec["reshards"]   # 14 heads of 64 over 16 ranks


def test_pod_placements_and_sync_steps_on_a_fake_mesh():
    """``P(("pod", "data"), None)`` on a fake (2, 16, 16) mesh: tensor
    dim 0 split over "pod" and each part over "data", pod-major, as jax
    splits it (rank 0's block of a DTensor placed by it, every
    coordinate's offset, and the spec back from the placements).  Then
    the sync steps of the qwen2-0.5b smoke config on that mesh: the FD
    sync's one cross-pod collective is its (NB, NB) float32 uplink mean,
    fewer bytes than the FL sync's parameter mean."""
    got = _run("""
        import json, torch
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor._utils import \\
            _compute_local_shape_and_global_offset as local
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun, sharding as shp
        from repro_torch.launch.mesh import make_production_mesh
        dryrun.start_fake_world()
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        out = {"names": list(mesh.mesh_dim_names), "blocks": []}
        for spec in (shp.P(("pod", "data"), None),
                     shp.P(None, ("pod", "data"), "model"),
                     shp.P("model", "data")):
            pl = shp.to_placements(mesh, spec, 3)
            t = distribute_tensor(torch.empty(64, 64, 32, device="meta"),
                                  mesh, pl, src_data_rank=None)
            offs = {f"{p},{d},{m}": local((64, 64, 32), (2, 16, 16),
                                          [p, d, m], pl)[1]
                    for p in range(2) for d in range(16) for m in (0, 5)}
            out["blocks"].append([list(t.to_local().shape), offs,
                                  list(shp.from_placements(mesh, pl, 3))])
        out["sync"] = dryrun.dry_run_sync_steps(
            "qwen2-0.5b", save=False, cfg=get_config("qwen2-0.5b-smoke"))
        print(json.dumps(out))
        """)
    assert got["names"] == ["pod", "data", "model"]
    (s0, off0, back0), (s1, off1, back1), (s2, off2, back2) = got["blocks"]
    assert s0 == [2, 64, 32] and back0 == [["pod", "data"]]
    assert s1 == [64, 2, 2] and back1 == [None, ["pod", "data"], "model"]
    assert s2 == [4, 4, 32] and back2 == ["model", "data"]
    for key, off in off0.items():
        p, d, _ = map(int, key.split(","))
        assert off == [(p * 16 + d) * 2, 0, 0], key
    for key, off in off1.items():
        p, d, m = map(int, key.split(","))
        assert off == [0, (p * 16 + d) * 2, m * 2], key
    for key, off in off2.items():
        p, d, m = map(int, key.split(","))
        assert off == [m * 4, d * 4, 0], key
    fl, fd = got["sync"]
    assert [fl["status"], fd["status"]] == ["ok", "ok"], got["sync"]
    nb = configs.get_config("qwen2-0.5b-smoke").fd_buckets
    assert fd["cross_pod_bytes_per_device"] == nb * nb * 4
    assert fl["cross_pod_bytes_per_device"] > nb * nb * 4
    assert fd["collective_bytes_per_device"] > \
        fd["cross_pod_bytes_per_device"]


def test_host_mesh_serve_equals_the_plain_serve():
    """Parameters, prompts and cache placed by the rules on the (1, 1)
    host mesh of a one-rank gloo group, the hook installed: the greedy
    tokens equal the plain serve's bit for bit (the dense GQA,
    deepseek-v2's MoE dispatch constraints and MLA latent cache, written
    by ``write_slots``, and the SSD scan on each rank's rows of the
    mamba2 and zamba2 configs)."""
    got = _run("""
        import json, torch
        import torch.distributed as dist
        from repro_torch import rng
        from repro_torch.configs import get_config
        from repro_torch.data import synthetic_tokens
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.serve import serve
        from repro_torch.models.transformer import init_params
        torch.set_num_threads(1)
        mesh = make_host_mesh("cpu")
        out = {}
        for arch in ("qwen2-0.5b", "deepseek-v2-236b", "mamba2-370m",
                     "zamba2-2.7b"):
            cfg = get_config(arch).smoke()
            params = init_params(cfg, rng.PRNGKey(0), device="cpu")
            want = serve(cfg, 2, 40, 5, device="cpu", params=params,
                         log=lambda *a: None)
            prompts = synthetic_tokens(rng.PRNGKey(1), 2, 40,
                                       cfg.vocab_size, device="cpu")
            got = dryrun.serve_on_mesh(cfg, params, mesh, prompts, 5)
            out[arch] = [got.tolist(), want.tolist()]
        dist.destroy_process_group()
        print(json.dumps(out))
        """)
    for arch, (tokens, plain) in got.items():
        assert tokens == plain, arch
