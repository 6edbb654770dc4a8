"""Plain PyTorch versions of the 3xTF32 product, for the tests and the
card's checks.

``tf32_rna`` rounds float32 to TF32 (10 explicit mantissa bits) to
nearest, ties away from zero, as ``cvt.rna.tf32.f32`` does: on the bit
pattern, add half of the 13 dropped bits' weight to the magnitude and
clear them (a carry into the exponent is the right rounding up).
``gemm_3xtf32_ref`` is the kernel's arithmetic: each operand split into
big = tf32(x) and small = tf32(x - big), and small*big + big*small +
big*big summed in float32 (every product of two TF32 values is exact in
float32). ``gemm_tf32_ref`` is one TF32 pass, the precision the kernel
must not fall to.
"""
from __future__ import annotations

from typing import Tuple

import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as
    float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_3xtf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small): big = tf32(x), small = tf32(x - big)."""
    big = tf32_rna(x)
    return big, tf32_rna(x.float() - big)


def gemm_3xtf32_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) in 3xTF32 with float32 sums, the small terms
    first."""
    ab, as_ = split_3xtf32(a)
    bb, bs = split_3xtf32(b)
    return as_ @ bb + ab @ bs + ab @ bb


def gemm_tf32_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to TF32 once (plain TF32)."""
    return tf32_rna(a) @ tf32_rna(b)
