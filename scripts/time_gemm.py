#!/usr/bin/env python3
"""Check and time the 3xTF32 matrix-product kernel on one CUDA card.

    PYTHONPATH=src python3 scripts/time_gemm.py [--label NAME]

First the checks (they raise on a fault): every layout of A and B on
ragged shapes, split-K, one and eight rows, the products of the cells'
shapes against a float64 product beside cuBLAS float32's own error, a
split-K product repeated bit for bit, operands the kernel cannot read in
place (a base 4 bytes off, an odd row length, a broadcast) copied and
launched, and ``linear``'s gradients against float64 autograd, a
broadcast dY among them. Every timed shape's error is held to the same
limit (``gate``).
Then, at the shapes the benchmark's cells run (the LM at 16 x 1024
tokens, mamba2-780m at 4 x 2048, a fleet worker's 160, 1024 and 2048
tokens, an 8-row decode step), forward and both gradient products: device µs a
call (``--calls`` calls captured in a CUDA graph, replayed between CUDA
events, so the host's launch cost stays out), TFLOP/s and
the share of the 3xTF32 bound (3 x 2MNK at 495 TFLOP/s, or the bytes at
3.35 TB/s where larger), ``torch.matmul`` float32 (TF32 off) as the
library, the plain version (``ref.gemm_3xtf32_ref``) and the errors;
then the host's µs a call, queued without waiting, for the kernel's path
and ``linear`` (forward, and forward with backward) against
``torch.matmul``.
Prints one ``[gemm]`` line per shape and writes every row to
``chiprun_out/time_gemm_<label>.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels.gemm_3xtf32 import ops
from repro_torch.kernels.gemm_3xtf32.ref import gemm_3xtf32_ref
from repro_torch.kernels.runtime import resolve_device

PEAK_3XTF32 = 495e12 / 3         # float32 products a second, as 3xTF32
HBM = 3.35e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def operand(rows: int, cols: int, rows_contiguous: bool, gen):
    """A (rows, cols) float32 operand, its rows contiguous or its columns
    (a transposed view of a row-major matrix)."""
    if rows_contiguous:
        return torch.randn(rows, cols, generator=gen, device="cuda")
    return torch.randn(cols, rows, generator=gen, device="cuda").t()


def rel_err(c: torch.Tensor, exact: torch.Tensor) -> float:
    """max |c - exact| over max |exact|."""
    return float((c.double() - exact).abs().max()
                 / exact.abs().max().clamp_min(1e-300))


def within(err: float, cublas_err: float) -> bool:
    """The kernel's limit: 4x cuBLAS float32's error at the same shape, or
    2e-6 of the largest output where cuBLAS's is smaller still."""
    return err <= max(4.0 * cublas_err, 2e-6)


def splits(M: int, N: int, K: int) -> int:
    return ops.plan(M, N, K, torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count)


def check_pair(a, b, label: str) -> dict:
    """One launch of ``gemm(a, b)`` against float64, beside cuBLAS."""
    M, K = a.shape
    N = b.shape[1]
    n0 = ops.LAUNCHES.count
    c = ops.gemm(a, b)
    torch.cuda.synchronize()
    exact = a.double() @ b.double()
    got, lib = rel_err(c, exact), rel_err(a @ b, exact)
    ok = within(got, lib) and ops.LAUNCHES.count == n0 + 1
    print(f"[gemm-check] M {M} N {N} K {K} {label} splits "
          f"{splits(M, N, K)}: rel err {got:.3e} (cuBLAS f32 {lib:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"gemm_3xtf32 off at M {M} N {N} K {K} {label}")
    return {"M": M, "N": N, "K": K, "label": label, "rel_err": got,
            "cublas_rel_err": lib}


def check_case(M, N, K, a_rows, b_rows, gen):
    a = operand(M, K, a_rows, gen)
    b = operand(K, N, b_rows, gen)
    row = check_pair(a, b, f"A {'rows' if a_rows else 'cols'} B "
                           f"{'rows' if b_rows else 'cols'}")
    return dict(row, a_rows=a_rows, b_rows=b_rows)


def checks(gen) -> list:
    rows = []
    for a_rows in (True, False):
        for b_rows in (True, False):
            for M, N, K in ((300, 200, 100), (132, 136, 84), (1, 96, 40),
                            (8, 768, 768), (768, 256, 4096),
                            (129, 131, 84)):
                rows.append(check_case(M, N, K, a_rows, b_rows, gen))
    for M, N, K, ar, br in ((16384, 768, 768, True, True),
                            (768, 2048, 16384, False, True),
                            (4096, 32768, 768, True, False)):
        rows.append(check_case(M, N, K, ar, br, gen))
    # split-K repeats bit for bit
    a = operand(768, 16384, False, gen)
    b = operand(16384, 256, True, gen)
    first = ops.gemm(a, b)
    for _ in range(3):
        if not torch.equal(ops.gemm(a, b), first):
            raise SystemExit("gemm_3xtf32: split-K is not repeatable")
    # operands the kernel cannot read in place: copied, then launched
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    big = randn(64, 65)
    rows.append(check_pair(big[:, 1:], randn(64, 32), "A 4 bytes off"))
    rows.append(check_pair(randn(48, 64), randn(64, 33), "odd N"))
    rows.append(check_pair(randn(48, 37), randn(37, 40), "odd K"))
    rows.append(check_pair(randn(1, 64).expand(50, 64), randn(64, 40),
                           "A broadcast"))
    # linear's gradients, w a transposed view; dY given, then broadcast
    # (the gradient of a sum)
    for broadcast in (False, True):
        x = randn(3, 50, 96).requires_grad_(True)
        table = randn(200, 96).requires_grad_(True)
        dy = torch.ones(()).cuda().expand(3, 50, 200) if broadcast \
            else randn(3, 50, 200)
        n0 = ops.LAUNCHES.count
        ops.linear(x, table.t()).backward(dy)
        assert ops.LAUNCHES.count == n0 + 3, ops.LAUNCHES.count - n0
        xr = x.detach().double().requires_grad_(True)
        tr = table.detach().double().requires_grad_(True)
        (xr @ tr.t()).backward(dy.double())
        gx, gt = rel_err(x.grad, xr.grad), rel_err(table.grad, tr.grad)
        how = "broadcast" if broadcast else "given"
        print(f"[gemm-check] linear grads (dY {how}) rel err x {gx:.3e} "
              f"table {gt:.3e}", flush=True)
        if max(gx, gt) > 1e-5:
            raise SystemExit("gemm_3xtf32: linear's gradients are off")
    return rows


def gate(rows: list) -> None:
    """Raise where a timed shape's error against float64 is past
    ``within``'s limit."""
    bad = [r for r in rows if not within(r["rel_err"], r["cublas_rel_err"])]
    if bad:
        raise AssertionError(
            "gemm_3xtf32 past 4x cuBLAS f32's error at " + "; ".join(
                f"{r['cell']} {r['product']} M {r['M']} N {r['N']} K "
                f"{r['K']}: {r['rel_err']:.3e} (cuBLAS "
                f"{r['cublas_rel_err']:.3e})"
                for r in bad))


def shapes():
    """(cell, product, M, N, K, A rows contiguous, B rows contiguous)."""
    out = []

    def lin(cell, name, T, K, N, head=False):
        # forward x @ w (w (K, N) row-major, or the table.t() view),
        # dX = dY w^T, dW = x^T dY (dtable = dY^T x for the head)
        out.append((cell, f"{name}.fwd", T, N, K, True, not head))
        out.append((cell, f"{name}.dx", T, K, N, True, head))
        if head:
            out.append((cell, f"{name}.dw", N, K, T, False, True))
        else:
            out.append((cell, f"{name}.dw", K, N, T, False, True))
    T = 16 * 1024
    for name, K, N in (("q|o", 768, 768), ("k|v", 768, 256),
                       ("gate|up", 768, 2048), ("down", 2048, 768)):
        lin("lm", name, T, K, N)
    lin("lm", "head", T, 768, 32768, head=True)
    T = 4 * 2048
    lin("mamba2", "in_proj", T, 1536, 6448)
    lin("mamba2", "out_proj", T, 3072, 1536)
    lin("mamba2", "head", T, 1536, 50280, head=True)
    for T in (160, 1024, 2048):        # a fleet worker's rows x 16
        for name, K, N in (("q|o", 768, 768), ("k|v", 768, 256),
                           ("gate|up", 768, 2048), ("down", 2048, 768),
                           ("head", 768, 32768)):
            lin(f"fleet{T}", name, T, K, N, head=name == "head")
    for name, K, N in (("q|o", 768, 768), ("gate|up", 768, 2048),
                       ("head", 768, 32768)):
        out.append(("decode", f"{name}.fwd", 8, N, K, True, name != "head"))
    return out


def device_us(fn, calls: int) -> float:
    """Device µs a call: ``calls`` calls captured in a CUDA graph and
    replayed between two events, so the host's launch cost stays out."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return 1e3 * start.elapsed_time(end) / calls


def host_us(fn, calls: int = 200) -> float:
    """Host µs a call, queued without waiting (the launch path's cost)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def time_shape(cell, name, M, N, K, a_rows, b_rows, gen, calls) -> dict:
    """One product's row: device µs of the kernel, ``torch.matmul`` and
    the plain version, its bound, and both errors against float64."""
    a = operand(M, K, a_rows, gen)
    b = operand(K, N, b_rows, gen)
    flops = 2.0 * M * N * K
    bound_us = 1e6 * max(flops / PEAK_3XTF32,
                         4.0 * (M * K + K * N + M * N) / HBM)
    k_us = device_us(lambda: ops.gemm(a, b), calls)
    lib_us = device_us(lambda: torch.matmul(a, b), calls)
    plain_us = device_us(lambda: gemm_3xtf32_ref(a, b), 2) \
        if M * N * K <= 2 ** 34 else None
    exact = a.double() @ b.double()
    err, lib_err = rel_err(ops.gemm(a, b), exact), rel_err(a @ b, exact)
    return {"cell": cell, "product": name, "M": M, "N": N, "K": K,
            "a_rows": a_rows, "b_rows": b_rows,
            "splits": splits(M, N, K),
            "us": k_us, "tflops": flops / k_us * 1e-6, "bound_us": bound_us,
            "bound_share": bound_us / k_us, "library_us": lib_us,
            "plain_us": plain_us, "rel_err": err, "cublas_rel_err": lib_err}


def row_line(r: dict) -> str:
    plain = "-" if r["plain_us"] is None else f"{r['plain_us']:.1f}"
    return (f"[gemm] {r['cell']} {r['product']} M {r['M']} N {r['N']} K "
            f"{r['K']} splits {r['splits']}: {r['us']:.1f} us "
            f"({r['tflops']:.1f} TFLOP/s, {100 * r['bound_share']:.1f}% of "
            f"bound {r['bound_us']:.1f}); library {r['library_us']:.1f} "
            f"({r['library_us'] / r['us']:.2f}x); plain {plain}; rel err "
            f"{r['rel_err']:.2e} (cuBLAS {r['cublas_rel_err']:.2e})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_gemm: no CUDA card")
    resolve_device("cuda")                 # TF32 off, as the program runs
    card = card_line()
    t0 = time.perf_counter()
    built = ops.library()
    log = [ln for ln in built.log.splitlines()
           if "registers" in ln or "spill" in ln or "warn" in ln.lower()]
    print(f"[gemm] built in {time.perf_counter() - t0:.1f} s | {card}")
    for ln in log:
        print(f"[gemm] ptxas: {ln.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"label": args.label, "card": card, "ptxas": log}
    result["checks"] = checks(gen)
    rows = []
    for cell, name, M, N, K, ar, br in shapes():
        rows.append(time_shape(cell, name, M, N, K, ar, br, gen,
                               args.calls))
        print(row_line(rows[-1]), flush=True)
    gate(rows)
    a = torch.randn(1024, 768, device="cuda", requires_grad=True)
    w = torch.randn(768, 768, device="cuda", requires_grad=True)
    dy = torch.randn(1024, 768, device="cuda")
    with torch.no_grad():
        fwd = {"kernel": host_us(lambda: ops.gemm(a, w)),
               "linear": host_us(lambda: ops.linear(a, w)),
               "library": host_us(lambda: torch.matmul(a, w))}
    both = {"linear": host_us(lambda: ops.linear(a, w).backward(dy), 100),
            "library": host_us(lambda: (a @ w).backward(dy), 100)}
    result["host_us"] = {"forward": fwd, "forward_backward": both}
    print(f"[gemm] host us a call (1024 x 768 x 768), queued: forward "
          f"{fwd}; forward and backward {both}")
    result["rows"] = rows
    out = Path("chiprun_out") / f"time_gemm_{args.label}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
