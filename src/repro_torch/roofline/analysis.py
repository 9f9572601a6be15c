"""Roofline terms of the port on the NVIDIA H100:

  compute    = FLOPs / (ranks * peak FLOP/s)
  memory     = bytes / (ranks * HBM bandwidth)
  collective = collective bytes / (ranks * link bandwidth)

with the card's constants of ``launch/mesh.py`` (989 TFLOP/s bf16, 67
TFLOP/s float32, 3.35 TB/s HBM3, 450 GB/s NVLink a direction).

The collective bytes come from two sources.  ``collective_bytes_from_hlo``
parses XLA's optimized HLO text (the reference's dry-run artifacts; it
sums the result shapes of every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute, through ``while``
bodies by their trip counts).  ``collective_bytes_from_log`` counts the
port's own programs: the calls ``launch/mesh.py``'s collectives recorded
on their :class:`~repro_torch.launch.mesh.CollectiveLog`.  Both return
the same dict.
"""
from __future__ import annotations

import re

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# e.g.:  %all-gather.3 = bf16[16,2048]{1,0} all-gather(...)
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s+(" + "|".join(COLLECTIVES) + r")(-start|-done)?\(")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * DTYPE_BYTES[dtype]
    return total


_GROUPS_EXPLICIT_RE = re.compile(r"replica_groups=\{\{([\d,{} ]+)\}\}")
_GROUPS_IOTA_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")


_PAIRS_RE = re.compile(r"source_target_pairs=\{([\d,{} ]+)\}")


def _crosses_pods(instr_text: str, pod_size: int) -> bool:
    """True if any replica group spans devices from different pods."""
    m = _PAIRS_RE.search(instr_text)
    if m:  # collective-permute: {s,t} pairs
        for pair in m.group(1).split("},{"):
            ids = [int(x) for x in pair.replace("{", "").replace("}", "")
                   .split(",") if x.strip()]
            if len(ids) == 2 and ids[0] // pod_size != ids[1] // pod_size:
                return True
        return False
    m = _GROUPS_IOTA_RE.search(instr_text)
    if m:
        import numpy as np
        ng, gs = int(m.group(1)), int(m.group(2))
        dims = [int(d) for d in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            perm = [int(d) for d in m.group(4).split(",")]
            ids = ids.transpose(perm)
        groups = ids.reshape(ng, gs)
        return bool(((groups // pod_size).min(axis=1) !=
                     (groups // pod_size).max(axis=1)).any())
    m = _GROUPS_EXPLICIT_RE.search(instr_text)
    if m:
        for grp in m.group(1).split("},{"):
            ids = [int(x) for x in grp.replace("{", "").replace("}", "")
                   .split(",") if x.strip()]
            if ids and min(ids) // pod_size != max(ids) // pod_size:
                return True
        return False
    return True  # no groups listed: global collective (crosses pods)


_WHILE_RE = re.compile(
    r"while\([^)]*\), condition=%?([\w\.\-]+), body=%?([\w\.\-]+)"
    r".*?known_trip_count\":\{\"n\":\"(\d+)\"", re.DOTALL)
_WHILE_NOTRIP_RE = re.compile(
    r"while\([^)]*\), condition=%?([\w\.\-]+), body=%?([\w\.\-]+)")
_HEADER_RE = re.compile(r"^(ENTRY\s+)?%?([\w\.\-]+)\s*\(")


def _parse_computations(hlo_text: str):
    """Split optimized HLO into computation blocks. Returns
    (blocks: name -> body text, entry_name)."""
    blocks: dict[str, list[str]] = {}
    entry = None
    cur = None
    depth = 0
    for line in hlo_text.splitlines():
        if cur is None:
            if line.rstrip().endswith("{") and "(" in line:
                m = _HEADER_RE.match(line.strip())
                if not m:
                    continue
                cur = m.group(2)
                if m.group(1):
                    entry = cur
                blocks[cur] = []
                depth = 1
        else:
            depth += line.count("{") - line.count("}")
            if depth <= 0:
                cur = None
            else:
                blocks[cur].append(line)
    return {k: "\n".join(v) for k, v in blocks.items()}, entry


def collective_bytes_from_hlo(hlo_text: str, pod_size: int = 0) -> dict:
    """Loop-aware per-device collective bytes.

    SPMD-partitioned HLO reports shard shapes (per-device bytes), but a
    plain text scan counts each scan (``while``) body ONCE.  We recurse
    through while ops using their ``known_trip_count`` backend configs,
    so an FSDP all-gather inside the 60-layer scan counts 60 times.

    With ``pod_size`` > 0, bytes of collectives whose replica groups span
    pods are additionally reported as ``cross_pod`` (the paper's scarce
    inter-pod "uplink" direction).
    """
    blocks, entry = _parse_computations(hlo_text)

    memo: dict[str, dict] = {}

    def visit(name: str) -> dict:
        if name in memo:
            return memo[name]
        text = blocks.get(name, "")
        acc = {k: 0 for k in COLLECTIVES}
        acc["cross_pod"] = 0
        cnt = {k: 0 for k in COLLECTIVES}
        for line in text.splitlines():
            m = _OP_RE.search(line)
            if not m:
                continue
            shape_str, kind, phase = m.group(1), m.group(2), m.group(3)
            if phase == "-done":
                continue
            nbytes = _shape_bytes(shape_str)
            acc[kind] += nbytes
            cnt[kind] += 1
            if pod_size and _crosses_pods(line, pod_size):
                acc["cross_pod"] += nbytes
        # recurse into while bodies with trip counts
        seen_bodies = set()
        for m in _WHILE_RE.finditer(text):
            body, trip = m.group(2), int(m.group(3))
            seen_bodies.add(body)
            sub = visit(body)
            for k in list(COLLECTIVES) + ["cross_pod"]:
                acc[k] += trip * sub[k]
            for k in COLLECTIVES:
                cnt[k] += trip * sub["counts"][k]
        for m in _WHILE_NOTRIP_RE.finditer(text):
            body = m.group(2)
            if body in seen_bodies:
                continue
            sub = visit(body)  # unknown trip: count once (conservative)
            for k in list(COLLECTIVES) + ["cross_pod"]:
                acc[k] += sub[k]
            for k in COLLECTIVES:
                cnt[k] += sub["counts"][k]
        acc["counts"] = cnt
        memo[name] = acc
        return acc

    out = visit(entry) if entry else {k: 0 for k in COLLECTIVES} | {
        "cross_pod": 0, "counts": {k: 0 for k in COLLECTIVES}}
    out = dict(out)
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def collective_bytes_from_log(log, pod_size: int = 0) -> dict:
    """Per-rank collective bytes of the port's own program, from the
    calls recorded on ``log`` (a :class:`~repro_torch.launch.mesh.
    CollectiveLog`, or its ``records``).  The dict of
    :func:`collective_bytes_from_hlo`: bytes per collective, ``counts``,
    ``total`` and, with ``pod_size`` > 0, ``cross_pod`` (the bytes of
    calls whose group spans ranks of different pods of ``pod_size``
    ranks)."""
    records = getattr(log, "records", log)
    out = {k: 0 for k in COLLECTIVES}
    out["cross_pod"] = 0
    cnt = {k: 0 for k in COLLECTIVES}
    for kind, nbytes, ranks in records:
        out[kind] += nbytes
        cnt[kind] += 1
        if pod_size and ranks and \
                min(ranks) // pod_size != max(ranks) // pod_size:
            out["cross_pod"] += nbytes
    out["counts"] = cnt
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def analytic_flops(cfg, shape, n_active: int) -> float:
    """Whole-program FLOPs model (global, all ranks), the reference's:
    2·N·tokens for inference, 8·N·tokens for training (forward, the
    recomputed forward and a backward of twice its cost), plus the
    attention and SSD terms.  ``shape`` is a ``configs.InputShape``."""
    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    tokens = B * (S if shape.kind != "decode" else 1)
    mult = 8 if train else 2
    total = float(mult) * n_active * tokens

    # attention term
    H, hd, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    if cfg.attn_type == "mla":
        hd = cfg.head_dim + cfg.rope_head_dim
    n_attn_layers = L if cfg.family != "hybrid" else L // max(
        cfg.attn_every, 1)
    if H and n_attn_layers:
        if shape.kind == "decode":
            skv = min(S, cfg.sliding_window or S)
            att = 4.0 * B * skv * H * hd * n_attn_layers
        else:
            skv = S / 2 if cfg.sliding_window is None else min(
                S / 2, cfg.sliding_window)
            att = 4.0 * B * S * skv * H * hd * n_attn_layers
            att *= 4 if train else 1  # bwd + remat re-fwd
        total += att

    # SSD term
    if cfg.ssm_state:
        Hs, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        ck = cfg.ssm_chunk
        if shape.kind == "decode":
            ssd = 6.0 * B * Hs * N * P * L
        else:
            per_tok = 2.0 * ck * (N + P) + 6.0 * N * P
            ssd = B * S * Hs * per_tok * L
            ssd *= 4 if train else 1
        total += ssd
    return total


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, chips: int,
                   peak_flops: float, hbm_bw: float, ici_bw: float) -> dict:
    """All three terms in seconds.  ``flops`` and ``bytes_accessed`` are
    per rank; ``collective_bytes`` is per rank; ``ici_bw`` is the link
    bandwidth (on the H100, ``launch.mesh.NVLINK_BW``)."""
    return {
        "compute_s": flops / peak_flops,
        "memory_s": bytes_accessed / hbm_bw,
        "collective_s": collective_bytes / ici_bw,
    }


def dominant_term(terms: dict) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k]).replace("_s", "")


def improvement_hint(record: dict) -> str:
    """One sentence per (arch x shape): what would move the dominant
    roofline term down."""
    dom = record.get("dominant", dominant_term(record["roofline"]))
    shape = record.get("shape", "")
    arch = record.get("arch", "")
    decode = "decode" in shape or "500k" in shape
    train = "train" in shape
    moe = "moe" in arch or "deepseek" in arch
    if dom == "collective":
        if decode:
            return ("TP-resident decode weights (drop the FSDP axis) "
                    "remove the per-layer weight gathers.")
        if moe:
            return ("Fewer grad-accum microbatches (gathers scale with "
                    "accum) and expert placement that keeps top-k traffic "
                    "within a node would cut the all-to-all and gather "
                    "volume.")
        if train:
            return ("Overlap the FSDP all-gathers with compute (issue "
                    "them on a side CUDA stream ahead of the layer that "
                    "needs them) or keep gathered weights across "
                    "microbatches.")
        return ("Shard the prefill KV over heads instead of sequence to "
                "avoid softmax-stat exchanges.")
    if dom == "memory":
        if decode:
            return ("An int8 KV cache halves the cache traffic; updating "
                    "the cache in place removes the second copy.")
        return ("Lower grad-accum microbatch size or tighten the "
                "recompute policy; the saved activations dominate.")
    return ("Compute-bound: raise arithmetic intensity with larger "
            "microbatches, or spill to more GPUs only if collectives "
            "stay sub-dominant.")


def recommend_execution(grid_size: int, num_devices: int, *,
                        avail: int,
                        compute_s: float | None = None,
                        channel_s: float | None = None,
                        min_hidden_frac: float = 0.05) -> dict:
    """Pick the round program's execution knobs — the 2-D ``(grid,
    device)`` mesh shape and the link-draw pipeline depth — for
    ``avail`` ranks (``core.program.ProgramOptions`` takes the result).

    **Mesh shape.**  Grid points share no reduction while device-axis
    shards pay an all-reduce per aggregation, so ranks go to the grid
    axis first: ``launch.mesh.grid_mesh_shape``'s auto shape at this
    rank budget.

    **Pipeline depth.**  A round is ``compute_s`` of local SGD on the
    device plus ``channel_s`` of host-side link simulation; dispatching
    a round's draw ahead hides ``min(compute_s, channel_s)`` a steady
    round.  Depth 2 when that is at least ``min_hidden_frac`` of the
    serial round, else 1 (depth beyond 2 never helps in steady state);
    with no timings, 1 — the strict-serial path."""
    from ..launch.mesh import grid_mesh_shape
    gs, ds = grid_mesh_shape(grid_size, num_devices, avail=avail)
    rec = {"mesh_shape": (gs, ds), "pipeline_depth": 1,
           "hidden_s": 0.0, "est_speedup": 1.0}
    if not compute_s or not channel_s:
        rec["rationale"] = ("no round timings: strict-serial depth 1 "
                            "(the bitwise oracle)")
        return rec
    serial = compute_s + channel_s
    hidden = min(compute_s, channel_s)
    rec["hidden_s"] = hidden
    rec["est_speedup"] = serial / max(compute_s, channel_s)
    if hidden >= min_hidden_frac * serial:
        rec["pipeline_depth"] = 2
        rec["rationale"] = (
            f"channel sim is {channel_s / serial:.0%} of the serial "
            f"round: double buffering hides {hidden * 1e3:.1f}ms/round "
            f"(est {rec['est_speedup']:.2f}x)")
    else:
        rec["rationale"] = (
            f"channel sim is only {channel_s / serial:.0%} of the "
            f"serial round: overlap would hide < {min_hidden_frac:.0%}, "
            f"stay serial")
    return rec


def summarize_combo(record: dict) -> str:
    t = record["roofline"]
    dom = dominant_term(t)
    return (f"{record['arch']:20s} {record['shape']:12s} "
            f"{record['mesh']:9s} "
            f"comp={t['compute_s']*1e3:9.3f}ms "
            f"mem={t['memory_s']*1e3:9.3f}ms "
            f"coll={t['collective_s']*1e3:9.3f}ms "
            f"dom={dom:10s} "
            f"useful={record.get('model_flops_ratio', float('nan')):.3f}")
