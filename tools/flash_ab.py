#!/usr/bin/env python3
"""The flash-attention kernel (B4) of two checkouts of the port, in turns,
on one GPU, beside PyTorch's SDPA.

    python3 tools/flash_ab.py OTHER_CHECKOUT [--dtype bfloat16|float32]
                              [--calls NAME ...]

Builds ``src/repro_torch/csrc/flash_attention.cu`` of OTHER_CHECKOUT and
of this checkout with nvcc (the port's flags) into ``build/flash_ab/``,
prints both checkouts' ptxas reports for the dtype's instantiations
(registers, spills, warnings), then, at each call of the dtype's calls
(bfloat16: ``CALLS``, the LM prefills' (B, H, Hkv, S, d, dv, window,
rope); float32: ``F32_CALLS``, the smoke, classifier and favg calls),
holds both against ``attention_plain`` (a few heads at a time; bfloat16
within 2 * 2**-6 and ``bf16_excess`` <= 1, float32 within 2e-5), says
whether the two outputs are equal bit for bit, and times them: device
time per launch (CUDA graphs of launches, median over replays, CUDA
events), in turns: other, this, SDPA, SDPA, this, other, three times.
A checkout whose ``flash_attention_launch`` takes the models' layout
(strides, kv heads, a shared key) gets q (B, S, H, d), K/V at Hkv heads
and MLA's rope key once; one that takes (BH, S, d) gets K/V repeated to
every query head and the rope key in every head's K, made before the
timing.  SDPA takes the repeated operands.  Prints the medians, this /
other, this / SDPA and this checkout's bound: the larger of the bytes
(q, k and v at their own heads, the shared key once, o) over 3.35 TB/s
and the operations over the peak (bfloat16: 989 TFLOP/s; float32: 67
TFLOP/s on the CUDA cores and, beside it, three products at 495
TFLOP/s, the 3xTF32 bound).  ``CHECKS`` and ``F32_CHECKS`` (off the
tiles, with windows) are only held to the plain version.  Needs a CUDA
GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

THIS = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(THIS / "src"))
sys.path.insert(0, str(THIS))

# name -> (B, H, Hkv, S, d, dv, window, rope): rope > 0, MLA's shared key
# (K's own columns d - rope)
CALLS = {
    "qwen2-vl-72b": (4, 64, 8, 1024, 128, 128, None, 0),
    "qwen3-14b": (4, 40, 8, 1024, 128, 128, None, 0),
    "deepseek-v2": (4, 128, 128, 1024, 192, 128, None, 64),
    "phi3-mini": (4, 32, 32, 1024, 96, 96, None, 0),
    "zamba2-2.7b": (4, 32, 32, 1024, 80, 80, None, 0),  # window >= S
    "qwen2-moe": (4, 16, 16, 1024, 128, 128, None, 0),
    "h2o-danube3": (2, 32, 8, 8192, 120, 120, 4096, 0),
    "qwen2-0.5b": (4, 14, 2, 1024, 64, 64, None, 0),
    "whisper-medium": (4, 16, 16, 1024, 64, 64, None, 0),
    "favg": (4, 14, 2, 512, 64, 64, None, 0),
    "d32": (56, 1, 1, 1024, 32, 32, None, 0),
}
CHECKS = ((4, 1, 1, 1084, 128, 128, None, 0),
          (4, 1, 1, 1084, 192, 128, None, 0),
          (1, 1, 1, 1084, 128, 128, 300, 0), (1, 1, 1, 128, 128, 128, None, 0),
          (3, 1, 1, 384, 128, 128, None, 0), (3, 1, 1, 512, 192, 128, 200, 0),
          (2, 8, 1, 300, 128, 128, None, 0), (1, 4, 4, 333, 192, 128, 50, 64))
ATOL = 2 * 2.0 ** -6
F32_CALLS = {
    "deepseek-v2 width192": (2, 4, 4, 40, 192, 128, None, 64),
    "deepseek-v2 smoke": (2, 4, 4, 40, 48, 32, None, 16),
    "classifier": (400, 1, 1, 16, 16, 16, None, 0),
    "zamba2 smoke favg": (8, 1, 1, 64, 32, 32, None, 0),
    "favg 25m": (32, 1, 1, 128, 64, 64, None, 0),
    "favg 100m": (48, 1, 1, 128, 64, 64, None, 0),
    "favg 25m seq 1024": (32, 1, 1, 1024, 64, 64, None, 0),
}
F32_CHECKS = ((4, 1, 1, 300, 128, 128, 7, 0),
              (8, 1, 1, 160, 192, 128, None, 0),
              (3, 1, 1, 333, 80, 80, 100, 0), (2, 1, 1, 1, 32, 32, None, 0),
              (8, 1, 1, 300, 120, 120, None, 0),
              (3, 1, 1, 200, 16, 128, 50, 0), (3, 6, 2, 300, 64, 64, 9, 0))
F32_ATOL = 2e-5


def build(checkout: Path, name: str):
    """One checkout's flash_attention.cu as a ctypes library, whether its
    entry point takes the models' layout, and ptxas's report."""
    from repro_torch.kernels import runtime

    src = checkout / "src/repro_torch/csrc/flash_attention.cu"
    out = THIS / "build" / "flash_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(out), str(src)],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                           f"{res.stderr}")
    heads = "const int64_t* strides" in src.read_text()
    fn = ctypes.CDLL(str(out)).flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int64)]
                   + [ctypes.c_int64] * 9 + [ctypes.c_void_p] if heads
                   else [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
                   + [ctypes.c_void_p])
    return (fn, heads), res.stdout + res.stderr


def ptxas_report(log: str, label: str, f32: bool) -> None:
    """The dtype's kernels' registers and spills, and every warning."""
    entry = None
    pattern = (r"flash_fwd_(?:f32|kernel)I?\w*?Li(\d+)ELi(\d+)E" if f32
               else r"flash_fwd_tcILi(\d+)ELi(\d+)E")
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "warning" in line:
            print(f"ptxas {label}: {line.strip()}")
        elif entry and ("registers" in line or "spill" in line):
            m = re.search(pattern, entry)
            if m:
                kernel = re.search(r"flash_fwd_[a-z0-9]+", entry)[0]
                print(f"ptxas {label} {kernel}<{m[1]}, {m[2]}>: "
                      f"{line.strip()}")


class Operands:
    """A call's operands in the models' layout (q (B, S, H, d), K/V at
    Hkv heads, the shared key (B, S, rope) or None) and, made once, the
    (BH, S, d) ones: K with the shared key appended, K/V repeated to
    every query head, the heads flattened into the batch."""

    def __init__(self, gen, B, H, Hkv, S, d, dv, rope, dtype):
        def draw(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        self.q, self.k = draw(B, S, H, d), draw(B, S, Hkv, d - rope)
        self.v = draw(B, S, Hkv, dv)
        self.ks = draw(B, S, rope) if rope else None
        k = self.k if not rope else torch.cat(
            [self.k, self.ks[:, :, None].expand(B, S, Hkv, rope)], -1)
        G = H // Hkv

        def flat(t):
            return t.permute(0, 2, 1, 3).reshape(B * H, S, t.shape[-1]) \
                .contiguous()

        self.flat = (flat(self.q), flat(k.repeat_interleave(G, 2)),
                     flat(self.v.repeat_interleave(G, 2)))

    def nbytes(self):
        """q, k, v at their own heads, the shared key once, o."""
        ops = (self.q, self.k, self.v) + (() if self.ks is None
                                           else (self.ks,))
        return (sum(t.numel() for t in ops) + self.q[..., :1].numel()
                * self.v.shape[-1]) * self.q.element_size()


def launcher(lib, ops, window):
    """A call of one checkout's launch on ``ops``; its output, (BH, S,
    dv) either way."""
    from repro_torch.kernels.flash_attention import tma_strides

    fn, heads = lib
    q, k, v = (ops.q, ops.k, ops.v) if heads else ops.flat
    dtype = 0 if q.dtype == torch.float32 else 1
    if heads:
        B, S, H, d = q.shape
        out = torch.empty(B, S, H, v.shape[-1], dtype=q.dtype, device="cuda")
        strides = (ctypes.c_int64 * 15)(*tma_strides(q, k, v, ops.ks))

        def call():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if ops.ks is None else ops.ks.data_ptr(),
                     out.data_ptr(), strides, B, H, k.shape[2], S, d,
                     k.shape[-1], v.shape[-1], window or -1, dtype,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"flash_attention_launch: CUDA error {err}")
        return call, lambda: out.permute(0, 2, 1, 3).reshape(
            B * H, S, v.shape[-1])
    bh, s, d = q.shape
    out = torch.empty(bh, s, v.shape[-1], dtype=q.dtype, device="cuda")

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, s, d, v.shape[-1], window or -1, dtype,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_launch: CUDA error {err}")
    return call, lambda: out


def hold(libs, ops, window, label):
    """Both libraries' outputs against the plain version, and against
    each other."""
    from chip_smoke import plain_by_heads
    from repro_torch.kernels.flash_attention import bf16_excess

    q = ops.flat[0]
    f32 = q.dtype == torch.float32
    want = plain_by_heads(*ops.flat, window)
    calls, outs = {}, {}
    for name, lib in libs.items():
        calls[name], result = launcher(lib, ops, window)
        calls[name]()
        torch.cuda.synchronize()
        outs[name] = result()
        err = float((outs[name].float() - want.float()).abs().max())
        x = 0.0 if f32 else bf16_excess(outs[name], want)
        print(f"{label} {name}: max |err| {err:.3g}"
              + ("" if f32 else f", {x:.3f} of the per-element bound"))
        if err > (F32_ATOL if f32 else ATOL) or x > 1:
            raise RuntimeError(f"{label} {name}: err {err}, excess {x}")
    print(f"{label}: other and this bit-equal: "
          f"{torch.equal(outs['other'], outs['this'])}")
    return calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--calls", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from chip_smoke import (BF16_OPS_PER_S, F32_OPS_PER_S, TF32_OPS_PER_S,
                            attended_pairs, bound_ms, device_ms, nvidia_smi)

    f32 = args.dtype == "float32"
    dtype = torch.float32 if f32 else torch.bfloat16
    table, checks = (F32_CALLS, F32_CHECKS) if f32 else (CALLS, CHECKS)
    (other, log_other), (this, log) = (
        build(Path(args.other).resolve(), "other"), build(THIS, "this"))
    ptxas_report(log_other, "other", f32)
    ptxas_report(log, "this", f32)
    libs = {"other": other, "this": this}
    print(f"entry points: other {'(B, S, H, d)' if other[1] else '(BH, S, d)'}"
          f", this {'(B, S, H, d)' if this[1] else '(BH, S, d)'}")
    print(nvidia_smi())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, Hkv, s, d, dv, window, rope in checks:
        hold(libs, Operands(gen, B, H, Hkv, s, d, dv, rope, dtype), window,
             f"check {(B, H, Hkv, s, d, dv, rope)} {args.dtype} window "
             f"{window}")
    rows = []
    for name in args.calls or list(table):
        B, H, Hkv, s, d, dv, window, rope = table[name]
        ops = Operands(gen, B, H, Hkv, s, d, dv, rope, dtype)
        calls = hold(libs, ops, window,
                     f"{name} {(B, H, Hkv, s, d, dv, rope)}")
        fq, fk, fv = (t[None] for t in ops.flat)
        if window is None:
            def lib():
                return F.scaled_dot_product_attention(fq, fk, fv,
                                                      is_causal=True)
        else:
            pos = torch.arange(s, device="cuda")
            keep = ((pos[None, :] <= pos[:, None])
                    & (pos[:, None] - pos[None, :] < window))

            def lib():
                return F.scaled_dot_product_attention(fq, fk, fv,
                                                      attn_mask=keep)
        reps = (10, 5) if s >= 4096 else (20, 20)
        t = {"other": [], "this": [], "sdpa": []}
        for _ in range(3):
            for who in ("other", "this", "sdpa", "sdpa", "this", "other"):
                t[who].append(device_ms(lib if who == "sdpa"
                                        else calls[who], *reps))
        med = {w: statistics.median(x) for w, x in t.items()}
        pairs = attended_pairs(B * H, s, window)
        nbytes = ops.nbytes()
        nops = 2 * pairs * (d + dv)
        bounds = ([bound_ms(nbytes, nops, F32_OPS_PER_S),
                   bound_ms(nbytes, 3 * nops, TF32_OPS_PER_S)] if f32
                  else [bound_ms(nbytes, nops, BF16_OPS_PER_S)])
        shape = (B, H, Hkv, s, d, dv, window, rope)
        print(f"{name} {shape}: other "
              f"{[round(x, 6) for x in t['other']]}, this "
              f"{[round(x, 6) for x in t['this']]}, sdpa "
              f"{[round(x, 6) for x in t['sdpa']]} ms; this bound's bytes "
              f"{nbytes}")
        rows.append((name, shape, med, bounds))
        del ops, calls, fq, fk, fv
    print("call | other ms | this ms | this/other | SDPA ms | this/SDPA | "
          "bound ms (by) and share of it"
          + (": float32 CUDA cores; 3xTF32" if f32 else ""))
    for name, shape, med, bounds in rows:
        shares = "; ".join(f"{b:.6f} ({by}) {b / med['this']:.3f}"
                           for b, by in bounds)
        print(f"{name} {shape} | {med['other']:.6f} | {med['this']:.6f} | "
              f"{med['this'] / med['other']:.3f} | {med['sdpa']:.6f} | "
              f"{med['this'] / med['sdpa']:.3f} | {shares}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
