#!/usr/bin/env python3
"""The SSD scan kernel (B5) of two checkouts of the port, in turns, on one
GPU.

    python3 tools/ssd_ab.py OTHER_CHECKOUT [--shapes NAME ...]

Builds ``src/repro_torch/csrc/ssd_scan.cu`` of OTHER_CHECKOUT (for
instance the parent commit, unpacked with ``git archive`` into
``build/``) and of this checkout with nvcc (the port's flags) into
``build/ssd_ab/``, prints both ptxas reports for the SSD kernels
(registers, spills, warnings), then at each serve shape (``SHAPES``: the
zamba2-2.7b and mamba2-370m prefills' calls, batch 4, prompt 1024, final
state on) draws the mixer's operands in the models' layout (x (B, S, H,
P), dt, A, B and C (B, S, G, N)) and makes from them the (BH, S, P) rows
the mixer used to pass: x * dt, B and C by group, dA.  Both checkouts'
``ssd_scan_launch`` (the (BH, S, P) symbol) run on the rows: they must be
equal bit for bit, and within atol 2e-4 + rtol 1e-3 of
``ssd_scan_plain`` (y and final state).  This checkout's models'-layout
entry (``ssd_scan_heads``, dt folded into the kernel) runs on the
mixer's operands, held to ``ssd_scan_heads_plain`` within the same
tolerance, and again with x, B and C stored (B, H, S, P) and passed as
(B, S, H, P) views (each head's rows contiguous, as the (BH, S, P) rows
are: what the models' strided rows cost, apart from dt's folding).  The
four are timed in turns (other, this, heads, heads on that storage, and
back, three times: six device times each, CUDA graphs of 20 calls,
median of 20 replays), and each inner launch's device time is printed
(the profiler, 20 calls).  ``--digests`` prints both checkouts' sha-256
of the (BH, S, P) symbol's y and state at ``chip_smoke.SSD_DIGEST_CASES``
(numpy-drawn inputs) for ``chip_smoke.SSD_ROWS_DIGESTS``, and stops.
Prints the medians, this / other, heads / other and the bound of
``chip_smoke.ssd_flops`` (3xTF32 operations at 495 TFLOP/s with C . B^T
counted once a group; bytes at 3.35 TB/s), with the card's name and
power limit.  Needs a CUDA GPU.
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

# name -> (B, S, H, P, G, N, chunk)
SHAPES = {
    "zamba2-2.7b": (4, 1024, 80, 64, 1, 64, 256),
    "mamba2-370m": (4, 1024, 32, 64, 1, 128, 256),
}
KERNELS = ("chunk_scores", "chunk_states", "state_pass", "chunk_scan")


def build(checkout: Path, name: str):
    """One checkout's ssd_scan.cu as a ctypes function, and ptxas's
    report."""
    from repro_torch.kernels import runtime

    out = THIS / "build" / "ssd_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(out),
         str(checkout / "src/repro_torch/csrc/ssd_scan.cu")],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                           f"{res.stderr}")
    fn = ctypes.CDLL(str(out)).ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6 + [
        ctypes.c_void_p]
    return fn, res.stdout + res.stderr


def ptxas_report(log: str, label: str) -> None:
    """The SSD kernels' registers and spills, and every warning."""
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "warning" in line:
            print(f"ptxas {label}: {line.strip()}")
        elif entry and ("registers" in line or "spill" in line):
            kernel = re.search("|".join(KERNELS), entry)
            sizes = re.search(r"ILi(\d+)ELi(\d+)E(Lb(\d)E)?", entry)
            if kernel and (sizes is None or sizes.groups()[:2] in
                           (("64", "64"), ("64", "128"))):
                tag = (f"<{sizes[1]}, {sizes[2]}"
                       + (f", dt {sizes[4]}" if sizes[4] else "") + ">"
                       if sizes else "")
                print(f"ptxas {label} {kernel[0]}{tag}: {line.strip()}")


def rows(t):
    """(B, S, X, Y) -> (B X, S, Y), contiguous: the mixer's old rows."""
    return t.permute(0, 2, 1, 3).reshape(-1, t.shape[1],
                                         t.shape[-1]).contiguous()


def operands(dev, B, S, H, P, G, N, seed):
    """The mixer's operands in the models' layout and the rows made from
    them as the mixer made them (x * dt, dA = dt A, by rows)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 0.5 * torch.randn(B, S, H, P, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device=dev))
    A = -torch.linspace(0.2, 1.2, H, device=dev)
    Bm, Cm = (0.5 * torch.randn(B, S, G, N, generator=gen, device=dev)
              for _ in range(2))
    flat = (rows(x * dt[..., None]), rows(Bm), rows(Cm),
            (dt * A).permute(0, 2, 1).reshape(B * H, S).contiguous())
    return (x, dt, A, Bm, Cm), flat


def launcher(fn, xdt, B, C, dA, y, state, chunk, hpg, init=None):
    from repro_torch.kernels.ssd_scan import scratch_floats

    bh, s, p = xdt.shape
    n = B.shape[-1]
    # room for either checkout's scratch layout
    floats = max(scratch_floats(bh, s, p, n, chunk, hpg),
                 bh * (s // chunk) * (n * p + 1))
    scratch = torch.empty(floats, device="cuda")

    def call():
        err = fn(xdt.data_ptr(), B.data_ptr(), C.data_ptr(), dA.data_ptr(),
                 None if init is None else init.data_ptr(), y.data_ptr(),
                 state.data_ptr(), scratch.data_ptr(), bh, s, p, n, chunk,
                 hpg, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ssd_scan_launch: CUDA error {err}")
    return call


def symbol_launch(fn):
    """A checkout's ``ssd_scan_launch`` as ``launch(xdt, B, C, dA, chunk,
    heads_per_group, init) -> (y, final state)``."""
    def launch(xdt, B, C, dA, chunk, hpg, init):
        y = torch.empty_like(xdt)
        st = torch.empty(xdt.shape[0], B.shape[-1], xdt.shape[-1],
                         device=xdt.device)
        launcher(fn, xdt, B, C, dA, y, st, chunk, hpg, init)()
        return y, st
    return launch


def digests(other, this) -> int:
    """``chip_smoke.SSD_ROWS_DIGESTS``'s entry for this nvcc: the digests
    of both checkouts' (BH, S, P) symbol at ``SSD_DIGEST_CASES``."""
    from chip_smoke import SSD_DIGEST_CASES, nvcc_release, ssd_rows_digests

    dev = torch.device("cuda", 0)
    cases = [c for arch in SSD_DIGEST_CASES for c in SSD_DIGEST_CASES[arch]]
    got = {who: ssd_rows_digests(dev, symbol_launch(fn), cases)
           for who, fn in (("other", other), ("this", this))}
    same = got["other"] == got["this"]
    print(f"(BH, S, P) symbol digests, other and this checkout equal: "
          f"{same}")
    print(f"{nvcc_release()!r}: {{")
    for case, digest in got["other"].items():
        print(f"    {case}:\n        {digest!r},")
    print("},")
    return 0 if same else 1


def launch_times(call) -> dict:
    """Each inner launch's device ms a call, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        kernel = re.search("|".join(KERNELS), e.key)
        if e.self_device_time_total > 0 and kernel:
            out[kernel[0]] = e.self_device_time_total / 20 / 1e3
    return out


def within(got, want, atol, rtol) -> bool:
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--shapes", nargs="*", choices=list(SHAPES))
    ap.add_argument("--digests", action="store_true",
                    help="print both checkouts' (BH, S, P) digests for "
                         "chip_smoke.SSD_ROWS_DIGESTS and stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from chip_smoke import (HBM_BYTES_PER_S, SSD_ATOL, SSD_RTOL,
                            TF32_OPS_PER_S, bound_ms, device_ms, nvidia_smi,
                            ssd_flops)
    from repro_torch.kernels.ssd_scan import (ssd_scan_heads,
                                              ssd_scan_heads_plain,
                                              ssd_scan_plain)

    (other, log_other), (this, log) = (
        build(Path(args.other).resolve(), "other"), build(THIS, "this"))
    ptxas_report(log_other, "other")
    ptxas_report(log, "this")
    print(nvidia_smi())
    if args.digests:
        return digests(other, this)
    dev = torch.device("cuda", 0)
    rows_out = []
    for name in args.shapes or list(SHAPES):
        B, S, H, P, G, N, chunk = SHAPES[name]
        bh, hpg = B * H, H // G
        heads_ops, flat = operands(dev, B, S, H, P, G, N, 31)
        xdt, Bh, Ch, dA = flat
        want_y, want_st = ssd_scan_plain(xdt, Bh, Ch, dA, chunk, hpg)
        calls, outs = {}, {}
        for who, fn in (("other", other), ("this", this)):
            y, st = torch.empty_like(xdt), torch.empty(bh, N, P, device=dev)
            calls[who] = launcher(fn, xdt, Bh, Ch, dA, y, st, chunk, hpg)
            calls[who]()
            torch.cuda.synchronize()
            outs[who] = (y, st)
            errs = [float((got - want).abs().max())
                    for got, want in ((y, want_y), (st, want_st))]
            print(f"{name} {who} (BH, S, P): max |err| y {errs[0]:.3g}, "
                  f"state {errs[1]:.3g}")
            if not (within(y, want_y, SSD_ATOL, SSD_RTOL)
                    and within(st, want_st, SSD_ATOL, SSD_RTOL)):
                raise RuntimeError(f"{name} {who}: outside the tolerance")
        same = all(torch.equal(a, b) for a, b in zip(outs["other"],
                                                     outs["this"]))
        print(f"{name}: this checkout's (BH, S, P) symbol equals the "
              f"other's bit for bit: {same}")

        def heads():
            return ssd_scan_heads(*heads_ops, chunk, final=True)

        def rows_storage(t):   # (B, X, S, Y) storage, a (B, S, X, Y) view
            return t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)

        stored = [rows_storage(t) if t.dim() == 4 else t for t in heads_ops]

        def heads_rows():
            return ssd_scan_heads(*stored, chunk, final=True)

        calls["heads"], calls["heads_rows"] = heads, heads_rows
        hy, hst = heads()
        ry, rst = heads_rows()
        torch.cuda.synchronize()
        print(f"{name} heads on (B, H, S, P) storage equals heads on the "
              f"models' layout bit for bit: "
              f"{bool(torch.equal(hy, ry) and torch.equal(hst, rst))}")
        wy, wst = ssd_scan_heads_plain(*heads_ops, chunk)
        torch.cuda.synchronize()
        e = (float((hy - wy).abs().max()), float((hst - wst).abs().max()))
        old_y = outs["other"][0].reshape(B, H, S, P).permute(0, 2, 1, 3)
        old_st = outs["other"][1].reshape(B, H, N, P)
        print(f"{name} heads (B, S, H, P), dt folded: max |err| y "
              f"{e[0]:.3g}, state {e[1]:.3g}; against the other's rows "
              f"route: y {float((hy - old_y).abs().max()):.3g}, state "
              f"{float((hst - old_st).abs().max()):.3g}")
        if not (within(hy, wy, SSD_ATOL, SSD_RTOL)
                and within(hst, wst, SSD_ATOL, SSD_RTOL)):
            raise RuntimeError(f"{name} heads: outside the tolerance")
        t = {"other": [], "this": [], "heads": [], "heads_rows": []}
        for _ in range(3):
            for who in ("other", "this", "heads", "heads_rows", "heads_rows",
                        "heads", "this", "other"):
                t[who].append(device_ms(calls[who]))
        med = {w: statistics.median(x) for w, x in t.items()}
        print(f"{name} {SHAPES[name]}: " + "; ".join(
            f"{w} {[round(x, 6) for x in v]} ms" for w, v in t.items()))
        for who in ("other", "this", "heads", "heads_rows"):
            inner = launch_times(calls[who])
            print(f"{name} {who} launches: "
                  + ", ".join(f"{k} {v:.6f} ms" for k, v in inner.items()))
        nbytes = 4 * (2 * xdt.numel() + Bh.numel() + Ch.numel() + dA.numel()
                      + bh * N * P)
        bound, by = bound_ms(nbytes, 3 * ssd_flops(bh, S, P, N, chunk, hpg),
                             TF32_OPS_PER_S)
        rows_out.append((name, med, bound, by,
                         nbytes / HBM_BYTES_PER_S * 1e3, same))
        del heads_ops, stored, flat, xdt, Bh, Ch, dA, calls, outs
    print("shape | other ms | this ms | heads ms | heads on (B, H, S, P) "
          "storage ms | this/other | heads/other | bound ms (by) | share of "
          "the bound (heads) | bytes ms | bit-equal")
    for name, med, bound, by, bytes_ms, same in rows_out:
        print(f"{name} | {med['other']:.6f} | {med['this']:.6f} | "
              f"{med['heads']:.6f} | {med['heads_rows']:.6f} | "
              f"{med['this'] / med['other']:.3f} | "
              f"{med['heads'] / med['other']:.3f} | {bound:.6f} ({by}) | "
              f"{bound / med['heads']:.3f} | {bytes_ms:.6f} | {same}")
    return 0 if all(r[-1] for r in rows_out) else 1


if __name__ == "__main__":
    sys.exit(main())
