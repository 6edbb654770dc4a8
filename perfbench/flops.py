"""The yardstick's arithmetic: a model's FLOPs a trained token, a matrix
product's least time (an ``aten`` product's or the program's ``linear``'s,
from recorded shapes), and the chip's peaks (``peaks.json``).

A trained token costs 6 x the matrix parameters it passes through (two
FLOPs a multiply-add, forward and the two products of the backward pass;
the tied head counts, the embedding's gather does not), plus the
sequence mixing's products, also x 3. Both counts are the family's
(``reference.families.<arch_type>``: ``matmul_params``,
``mixing_flops_per_token``, whose docstrings give the mixing's count).

Recomputation (remat) is not counted: the FLOPs are the ones the passes
require."""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Sequence

from perfbench.reference.models import family

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
ELEMENT_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2,
                 "double": 8}


def matmul_params(cfg: dict) -> int:
    return family(cfg).matmul_params(cfg)


def mixing_flops_per_token(cfg: dict, seq: int) -> int:
    """Forward FLOPs a token of the sequence mixing's products, all layers."""
    return family(cfg).mixing_flops_per_token(cfg, seq)


def train_flops_per_token(cfg: dict, seq: int) -> int:
    return 6 * matmul_params(cfg) + 3 * mixing_flops_per_token(cfg, seq)


def peak_flops(precision: str) -> float:
    return float(PEAKS["flops_per_s"][precision])


def gemm_mnk(op: str, shapes: Sequence[Sequence[int]]):
    """(batch, M, N, K) of one recorded product, from its input shapes."""
    if op in ("aten::mm",):
        (M, K), (_, N) = shapes[0], shapes[1]
        return 1, M, N, K
    if op == "aten::addmm":
        (M, K), (_, N) = shapes[1], shapes[2]
        return 1, M, N, K
    if op == "aten::bmm":
        (b, M, K), (_, _, N) = shapes[0], shapes[1]
        return b, M, N, K
    if op == "aten::baddbmm":
        (b, M, K), (_, _, N) = shapes[1], shapes[2]
        return b, M, N, K
    raise ValueError(op)


def linear_mnk(shapes: Sequence[Sequence[int]]):
    """(1, M, N, K) of the program's ``linear(x, w)`` from its forward's
    recorded input shapes, x (..., K) and w (K, N): M is x's rows. Its
    backward's two products, dX = dY w^T and dW = x^T dY, each take the
    same 2 M N K and touch the same three matrices (x or dX, w or dW, y
    or dY), so each has the forward's least time."""
    x, (_, N) = shapes[0], shapes[1]
    return 1, math.prod(x[:-1]), N, x[-1]


def product_bound_s(b: int, M: int, N: int, K: int, element_bytes: int,
                    precision: str) -> float:
    """The least time of ``b`` M x K by K x N products: the larger of
    2 b M N K over the peak of ``precision`` and their bytes (each input
    read once, the output written once) over HBM's rate."""
    flops = 2.0 * b * M * N * K
    nbytes = float(element_bytes) * b * (M * K + K * N + M * N)
    return max(flops / peak_flops(precision),
               nbytes / float(PEAKS["hbm_bytes_per_s"]))
