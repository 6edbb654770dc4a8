"""``gemm_roofline``'s products: the program's ``linear`` counts as three
products of 2 M N K (its forward and its backward's two), a profiled mesh
step counts 6 x the matrix parameters x the tokens over its linear
products (and remat's recomputed block forward once more), and each
device operation is put down to the product that launched it.

On the CPU ``linear`` is ``x @ w``; here it is routed through its
autograd function as on the card, the kernel's launch stood in for by a
product that reads the operands from memory as the kernel does (and
launches no ``aten`` product of its own)."""
from __future__ import annotations

import ctypes
import importlib
from types import SimpleNamespace

import pytest
import torch

from perfbench.tests.support import CELLS, small_cell

from perfbench import flops  # noqa: E402
from perfbench.devtrace import (KERNEL, LINEAR, LINEAR_BACKWARD,  # noqa: E402
                                TraceData, attribute, products)

MESH = [n for n in CELLS if small_cell(n).traffic["driver"] == "mesh"]


def _operand_at(addr, rows, cols, lt):
    """The (rows, cols) float32 matrix at ``addr`` laid out as ``lt``
    (rows contiguous, leading stride)."""
    rows_contiguous, ld = lt
    inner, outer = (cols, rows) if rows_contiguous else (rows, cols)
    flat = torch.frombuffer(
        (ctypes.c_float * ((outer - 1) * ld + inner)).from_address(addr),
        dtype=torch.float32)
    return flat.as_strided((rows, cols),
                           (ld, 1) if rows_contiguous else (1, ld))


@pytest.fixture
def kernel_route(monkeypatch):
    from repro_torch.kernels.gemm_3xtf32 import ops

    def product(like, M, N, K, pa, la, pb, lb):
        a, b = _operand_at(pa, M, K, la), _operand_at(pb, K, N, lb)
        return (a.unsqueeze(2) * b.unsqueeze(0)).sum(1)
    monkeypatch.setattr(ops, "route", lambda a, b: "kernel")
    monkeypatch.setattr(ops, "_product", product)


def _recorded(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
    return list(p.profiler.kineto_results.events())


def test_a_linear_counts_three_products(kernel_route):
    from repro_torch.kernels.gemm_3xtf32.ops import linear

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 16, generator=g, requires_grad=True)
    w = torch.randn(12, 16, generator=g).t().requires_grad_(True)

    def step():
        linear(x, w).square().sum().backward()
    got = products(_recorded(step))
    bound = flops.product_bound_s(1, 16, 12, 16, 4, "float32")
    assert [p.kind for p in got] == [LINEAR, LINEAR_BACKWARD,
                                     LINEAR_BACKWARD]
    assert [p.flops for p in got] == [2.0 * 16 * 12 * 16] * 3
    assert [p.bound_s for p in got] == [bound] * 3
    assert got[1].op == got[2].op != got[0].op


@pytest.mark.parametrize("name", MESH)
def test_a_mesh_step_counts_its_linear_products(kernel_route, name):
    """6 x the matrix parameters x the step's tokens, plus 2 x the blocks'
    matrix parameters x the tokens where remat recomputes each block's
    forward (the tied head is not recomputed)."""
    cell = small_cell(name)
    drv = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}").Driver(
            cell, 2 ** 31 + 23, "cpu", False)
    drv.setup()
    got = products(_recorded(drv.step))
    cfg, t = cell.config, cell.traffic
    tokens = t["batch"] * t["seq"]
    params = flops.matmul_params(cfg)
    want = 6 * params * tokens
    if t["remat"]:
        want += 2 * (params - cfg["vocab_size"] * cfg["d_model"]) * tokens
    assert sum(p.flops for p in got if p.kind in (LINEAR, LINEAR_BACKWARD)) \
        == want


class _Event(SimpleNamespace):
    """A profiler event: a host op (``shapes``, ``seq``, ``thread``) or,
    with ``link``, a device operation launched by the op of that id."""

    def name(self):
        return self.n

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.d

    def device_type(self):
        return "DeviceType.CUDA" if hasattr(self, "link") else \
            "DeviceType.CPU"

    def shapes(self):
        return getattr(self, "s", [])

    def dtypes(self):
        return ["float"] * len(self.shapes())

    def correlation_id(self):
        return getattr(self, "id", 0)

    def linked_correlation_id(self):
        return self.link

    def sequence_nr(self):
        return getattr(self, "seq", -1)

    def start_thread_id(self):
        return getattr(self, "thread", 1)

    def fwd_thread_id(self):
        return getattr(self, "fwd", 0)


def test_device_time_goes_to_the_products_that_launched_it():
    k = f"void (anonymous namespace)::{KERNEL}<false, true>(CUtensorMap)"
    ev = [
        _Event(n=LINEAR, a=0, d=10, id=1, s=[[4, 256, 512], [512, 1024]],
               seq=7),
        _Event(n=LINEAR, a=20, d=10, id=2, s=[[64, 64], [64, 64]], seq=8),
        _Event(n="aten::bmm", a=40, d=10, id=3,
               s=[[8, 128, 64], [8, 64, 128]]),
        _Event(n="aten::bmm", a=60, d=10, id=4, s=[[8, 64, 64], [8, 64, 64]]),
        _Event(n=LINEAR_BACKWARD, a=80, d=10, id=5, s=[[4, 256, 1024]],
               seq=7, fwd=1),
        _Event(n=LINEAR_BACKWARD, a=100, d=10, id=6, s=[[64, 64]], seq=8,
               fwd=1),
        _Event(n=k, a=1, d=3000, link=1),
        _Event(n="sm90_xmma_gemm_f32f32", a=41, d=500, link=3),
        _Event(n=k, a=81, d=2000, link=5),
        _Event(n=k, a=85, d=2500, link=5),
        _Event(n=k, a=101, d=700, link=6),      # dW alone
        _Event(n=k, a=120, d=400, link=0),      # launched by no product
    ]
    out = TraceData(steps=1, window_s=1.0, busy_s=1.0)
    attribute(ev, out)
    big = flops.product_bound_s(1, 1024, 1024, 512, 4, "float32")
    small = flops.product_bound_s(1, 64, 64, 64, 4, "float32")
    bmm = flops.product_bound_s(8, 128, 128, 64, 4, "float32")
    # the small forward's launch never ran: it and the bmm without device
    # time are left out; the unlinked launch's time stays in
    assert out.gemm_bound_s == pytest.approx(3 * big + small + bmm)
    assert out.gemm_device_s == pytest.approx(
        (3000 + 2000 + 2500 + 700 + 400 + 500) * 1e-9)
    assert out.linear_flops == 3 * 2.0 * 1024 * 1024 * 512 + 2.0 * 64 ** 3
    assert out.kernel_launches == 5
