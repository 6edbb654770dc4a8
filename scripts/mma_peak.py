#!/usr/bin/env python3
"""Peak rate of mma.sync (TF32 m16n8k8 and bf16 m16n8k16) on one CUDA card.

    PYTHONPATH=src python3 scripts/mma_peak.py

Builds ``scripts/mma_peak.cu`` with the port's nvcc build
(``repro_torch.kernels.build``) and times 4 CTAs per SM, each warp
issuing 8 independent products per step; prints products per second and
TFLOP/s per type and block size beside the card's name and power limit.
The ceiling the port's mma.sync kernels (3xTF32: three TF32 products per
float32 one) can reach, against the tensor cores' dense peak that wgmma
reaches (495 TFLOP/s TF32, 989 bf16 on the H100 SXM data sheet).
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.build import build


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mma_peak: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    lib = build("mma_peak", [Path(__file__).with_name("mma_peak.cu")]).lib
    lib.mma_peak_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for bf16, name, flops in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                              (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for threads in (256, 512):
            blocks = 4 * sms
            lib.mma_peak_launch(bf16, blocks, threads, 16, out.data_ptr(),
                                stream)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            code = lib.mma_peak_launch(bf16, blocks, threads, iters,
                                       out.data_ptr(), stream)
            end.record()
            torch.cuda.synchronize()
            if code:
                raise RuntimeError(f"mma_peak: cudaError_t {code}")
            s = start.elapsed_time(end) * 1e-3
            n = blocks * threads // 32 * 8 * iters
            print(f"[mma-peak] {name}, {threads} threads a CTA: "
                  f"{n / s / 1e9:.1f} G products/s, "
                  f"{n * flops / s / 1e12:.1f} TFLOP/s | {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
