"""The 3xTF32 product's CPU side (``repro_torch.kernels.gemm_3xtf32``):
``linear`` is exactly ``x @ w`` on the CPU, forward and gradients; the
plain 3xTF32 emulation keeps float32's accuracy where one TF32 pass
does not; the dispatch rule, the copy of operands the kernel cannot read
in place, and the split-K plan; the wrapper's launches and the autograd
function's gradients against a Python stand-in for the C entry point
that reads the operands from memory as the kernel does; and every linear
product of the models the benchmark trains passes through ``linear``.
The kernel itself runs on the card only (``chip_smoke.py``'s ``[gemm]``
phase, ``scripts/time_gemm.py``).
"""
import ctypes
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.flatbuf import build_tree, tree_paths  # noqa: E402
from repro_torch.kernels.gemm_3xtf32 import ops  # noqa: E402
from repro_torch.kernels.gemm_3xtf32.ref import (  # noqa: E402
    gemm_3xtf32_ref, gemm_tf32_ref, split_3xtf32, tf32_rna)
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402


def _operands(case, seed=0):
    """(x, w) of one case: x 2-D or 3-D, w (K, N) or a transposed view."""
    g = torch.Generator().manual_seed(seed)
    K, N = 24, 40
    lead = (6,) if case.startswith("2d") else (2, 3)
    x = torch.randn(*lead, K, generator=g)
    if case.endswith("wt"):
        w = torch.randn(N, K, generator=g).t()
    else:
        w = torch.randn(K, N, generator=g)
    return x, w


CASES = ("2d", "3d", "2d-wt", "3d-wt")


@pytest.mark.parametrize("case", CASES)
def test_linear_on_cpu_is_x_at_w_bit_for_bit(case):
    x, w = _operands(case)
    dy = torch.randn(*x.shape[:-1], w.shape[1],
                     generator=torch.Generator().manual_seed(1))
    grads = []
    outs = []
    for f in (ops.linear, lambda a, b: a @ b):
        xa = x.clone().requires_grad_(True)
        wa = w.detach().clone().requires_grad_(True)
        y = f(xa, wa)
        y.backward(dy)
        outs.append(y.detach())
        grads.append((xa.grad, wa.grad))
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_linear_on_cpu_counts_nothing():
    ops.LAUNCHES.reset()
    x, w = _operands("3d")
    ops.linear(x, w)
    ops.gemm(x[0], w)
    assert ops.LAUNCHES.count == 0


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -12,
                      1.0 + 2 ** -12, 2.0 - 2 ** -12, 0.0, -0.0, 3.0])
    want = torch.tensor([1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0 + 2 ** -10,
                         1.0, 2.0, 0.0, -0.0, 3.0])
    assert torch.equal(tf32_rna(x), want)
    big, small = split_3xtf32(torch.randn(1000))
    assert torch.equal(tf32_rna(big), big)
    assert torch.equal(tf32_rna(small), small)
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("K", (768, 2048, 16384))
def test_3xtf32_emulation_keeps_float32_accuracy(K):
    g = torch.Generator().manual_seed(K)
    a = torch.randn(32, K, generator=g)
    b = torch.randn(K, 24, generator=g)
    exact = a.double() @ b.double()
    err3 = (gemm_3xtf32_ref(a, b).double() - exact).abs().max().item()
    err1 = (gemm_tf32_ref(a, b).double() - exact).abs().max().item()
    bound = 4 * 2 ** -21 * K * a.abs().max().item() * b.abs().max().item()
    assert err3 <= bound
    assert err3 * 100 <= err1


class _Fake:
    """What ``route`` and ``layout`` read of a tensor, on any device."""

    def __init__(self, shape, stride, dtype=torch.float32, device="cuda",
                 ptr=4096):
        self.shape, self._stride = tuple(shape), tuple(stride)
        self.dtype, self.device, self._ptr = dtype, torch.device(device), ptr

    def stride(self):
        return self._stride

    def data_ptr(self):
        return self._ptr


@pytest.mark.parametrize("a, b, want", [
    (_Fake((8, 16), (16, 1), device="cpu"), _Fake((16, 4), (4, 1)),
     "plain"),
    (_Fake((8, 16), (16, 1), device="meta"), _Fake((16, 4), (4, 1)),
     "plain"),
    (_Fake((8, 16), (16, 1), torch.bfloat16), _Fake((16, 4), (4, 1),
                                                    torch.bfloat16),
     "library"),
    (_Fake((8, 16), (16, 1), torch.float16), _Fake((16, 4), (4, 1)),
     "library"),
    (_Fake((8, 16), (16, 1)), _Fake((16, 4), (4, 1)), "kernel"),
    (_Fake((8, 16), (1, 8)), _Fake((16, 4), (1, 16)), "kernel"),
    (_Fake((1, 16), (99, 1)), _Fake((16, 4), (4, 1)), "kernel"),
    (_Fake((1, 6), (6, 1)), _Fake((6, 4), (4, 1)), "kernel"),
    (_Fake((6, 1), (1, 1)), _Fake((1, 4), (4, 1)), "kernel"),
    # strides the kernel cannot read in place still run it, on a copy
    (_Fake((6, 1), (5, 1)), _Fake((1, 4), (4, 1)), "kernel"),
    (_Fake((1, 6), (1, 5)), _Fake((6, 4), (4, 1)), "kernel"),
    (_Fake((8, 16), (16, 1)), _Fake((16, 6), (6, 1)), "kernel"),
    (_Fake((8, 16), (16, 1), ptr=4100), _Fake((16, 4), (4, 1)), "kernel"),
    (_Fake((8, 16), (32, 2)), _Fake((16, 4), (4, 1)), "kernel"),
    (_Fake((8, 16), (0, 1)), _Fake((16, 4), (4, 1)), "kernel"),
])
def test_route_by_device_dtype_and_strides(a, b, want):
    assert ops.route(a, b) == want


def test_layout_reads_real_strides():
    t = torch.empty(64, 48)
    assert ops.layout(t) == (True, 48)
    assert ops.layout(t.t()) == (False, 48)
    assert ops.layout(t[:, :40]) == (True, 48)
    assert ops.layout(t[:, 1:9]) is None          # base 4 bytes off
    assert ops.layout(t[::2]) == (True, 96)
    assert ops.layout(t[:, ::2]) is None


FIT_CASES = {
    "rows": lambda t: t[:, :40],
    "cols": lambda t: t.t(),
    "offset": lambda t: t[:, 1:9],             # base 4 bytes off
    "odd-rows": lambda t: t[:, :7].contiguous(),
    "strided": lambda t: t[:, ::2],
    "broadcast": lambda t: t[:1, :5].expand(6, 5),
    "one-element": lambda t: t[3:4, 5:6],
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_copies_what_the_kernel_cannot_read_in_place(case):
    """``fit`` hands on an operand the kernel reads in place untouched,
    and any other as a copy in rows padded to 16 bytes: equal values, a
    layout the kernel takes."""
    g = torch.Generator().manual_seed(2)
    t = FIT_CASES[case](torch.randn(64, 48, generator=g))
    out, lt = ops.fit(t)
    assert torch.equal(out, t)
    assert ops.layout(out) is not None and lt[1] % 4 == 0
    assert (out.data_ptr() == t.data_ptr()) == (ops.layout(t) is not None)
    if ops.layout(t) is not None:
        assert lt == ops.layout(t)
    else:
        assert lt == (True, out.stride(0)) and out.stride(1) == 1


def test_split_k_plan_follows_the_shape():
    sms = 132
    assert ops.plan(16384, 768, 768, sms) == 1           # forward
    assert ops.plan(16384, 32768, 768, sms) == 1         # the head
    for M, N, K in ((768, 256, 16384), (768, 768, 16384), (8, 768, 768),
                    (256, 768, 16384)):                  # dW, decode
        S = ops.plan(M, N, K, sms)
        nk = -(-K // ops.TILE_K)
        kper = -(-nk // S)
        assert 1 < S <= ops.MAX_SPLITS and (S - 1) * kper < nk
    assert ops.plan(5, 7, 3, sms) == 1


def _operand_at(addr, rows, cols, lt):
    """The (rows, cols) float32 matrix at ``addr`` laid out as ``lt``,
    read from memory as the kernel reads it."""
    rows_contiguous, ld = lt
    inner, outer = (cols, rows) if rows_contiguous else (rows, cols)
    n = (outer - 1) * ld + inner
    flat = torch.frombuffer((ctypes.c_float * n).from_address(addr),
                            dtype=torch.float32)
    return flat.as_strided((rows, cols),
                           (ld, 1) if rows_contiguous else (1, ld))


def _entry(launches):
    """A stand-in for ``gemm_3xtf32_launch``: checks the C contract (the
    .cu's entry-point comment) and writes C = A B, summed in float64."""
    def entry(pa, pb, pc, ws, tickets, stream, p):
        M, N, K, lda, ldb, ldc, trans_c, a_kmajor, b_kmajor, S, grid, dev = \
            (ctypes.c_longlong * 12).from_address(p)
        assert min(M, N, K) >= 1 and pa % 16 == 0 and pb % 16 == 0
        assert lda % 4 == 0 and ldb % 4 == 0
        assert not (a_kmajor and not b_kmajor)
        tiles = -(-M // ops.TILE_M) * -(-N // ops.TILE_N)
        assert 1 <= grid <= tiles * S
        assert (S > 1) == (ws is not None) == (tickets is not None)
        a = _operand_at(pa, M, K, (bool(a_kmajor), lda))
        b = _operand_at(pb, K, N, (not b_kmajor, ldb))
        c = (a.double() @ b.double()).float()
        out = _operand_at(pc, M, N, (not trans_c, ldc))
        out.copy_(c)
        launches.append((M, N, K, bool(trans_c), S))
        return 0
    return entry


@pytest.fixture
def emulated(monkeypatch):
    """``_product`` on the CPU, its C entry point stood in for by
    ``_entry``; yields the launches' (M, N, K, C^T written, splits)."""
    launches = []
    lib = types.SimpleNamespace(gemm_3xtf32_launch=_entry(launches))
    monkeypatch.setattr(ops, "library", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    monkeypatch.setattr(ops, "route", lambda a, b: "kernel")
    ops._config.cache_clear()
    yield launches
    ops._config.cache_clear()


@pytest.mark.parametrize("a_view", sorted(FIT_CASES))
@pytest.mark.parametrize("b_rows", (True, False))
def test_gemm_launch_reads_every_layout(emulated, a_view, b_rows):
    """``gemm`` through ``_product``: whatever A's strides (read in place
    or copied by ``fit``) and B's layout, the launch's arguments describe
    the operands' memory, and C^T is computed where both rows are
    contiguous."""
    g = torch.Generator().manual_seed(5)
    a = FIT_CASES[a_view](torch.randn(64, 48, generator=g))
    K = a.shape[1]
    b = torch.randn(K, 12, generator=g) if b_rows \
        else torch.randn(12, K, generator=g).t()
    c = ops.gemm(a, b)
    torch.testing.assert_close(c.double(), a.double() @ b.double(),
                               rtol=1e-6, atol=1e-6)
    assert c.is_contiguous() and len(emulated) == 1
    assert emulated[0][3] == (ops.fit(a)[1][0] and ops.fit(b)[1][0])


def test_split_k_launch_gets_its_workspace(emulated):
    """A weight gradient's shape splits K: the launch gets a workspace
    and the ticket array."""
    g = torch.Generator().manual_seed(6)
    a = torch.randn(16384, 24, generator=g).t()
    b = torch.randn(16384, 40, generator=g)
    c = ops.gemm(a, b)
    torch.testing.assert_close(c.double(), a.double() @ b.double(),
                               rtol=1e-5, atol=1e-5)
    assert emulated[0][4] > 1


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("wants", ("both", "x", "w"))
def test_autograd_function_gradients(emulated, case, wants):
    """``_Linear``'s forward and backward, each launch through the
    emulated entry point: the gradients equal autograd's of ``x @ w``,
    one launch per product asked for; a broadcast dY (the gradient of a
    sum) is copied and launched too."""
    x, w = _operands(case, seed=3)
    dy = torch.randn(*x.shape[:-1], w.shape[1],
                     generator=torch.Generator().manual_seed(4))
    for grad in (dy, torch.ones(()).expand(dy.shape)):
        emulated.clear()
        xa = x.clone().requires_grad_(wants in ("both", "x"))
        wa = w.detach().clone().requires_grad_(wants in ("both", "w"))
        y = ops._Linear.apply(xa, wa)
        y.backward(grad)
        xr = x.double().requires_grad_(True)
        wr = w.double().requires_grad_(True)
        (xr @ wr).backward(grad.double())
        torch.testing.assert_close(y.double(), (x.double() @ w.double()),
                                   rtol=1e-6, atol=1e-6)
        assert y.shape == x.shape[:-1] + (w.shape[1],)
        assert len(emulated) == 1 + (2 if wants == "both" else 1)
        if wants in ("both", "x"):
            assert xa.grad.shape == x.shape
            torch.testing.assert_close(xa.grad.double(), xr.grad, rtol=1e-6,
                                       atol=1e-6)
        if wants in ("both", "w"):
            assert wa.grad.shape == w.shape
            torch.testing.assert_close(wa.grad.double(), wr.grad, rtol=1e-6,
                                       atol=1e-6)
            if case.endswith("wt"):  # the table's rows, as the table lies
                assert wa.grad.t().is_contiguous()


@pytest.mark.parametrize("arch, per_layer", [("mlitb-lm-100m", 7),
                                             ("mamba2-780m", 2)])
def test_model_products_pass_through_linear(monkeypatch, arch, per_layer):
    """One forward and backward at ``.reduced()`` widths: every linear
    product (q, k, v, o, gate, up, down a layer; in_proj, out_proj a
    Mamba2 block; the tied head) calls ``linear``, and nothing else
    does."""
    cfg = get_config(arch).reduced()
    calls = []
    real = ops.linear

    def counting(x, w):
        calls.append(tuple(w.shape))
        return real(x, w)
    for mod in (t_attn, t_layers, t_ssm):
        monkeypatch.setattr(mod, "linear", counting)
    params = t_tf.init_params(cfg, device="cpu")
    paths, leaves = zip(*[(p, x.detach().requires_grad_(True))
                          for p, x in tree_paths(params)])
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    with torch.enable_grad():
        logits, _ = t_tf.forward(build_tree(paths, leaves), cfg, tokens,
                                 remat=False)
        assert len(calls) == cfg.n_layers * per_layer + 1
        assert calls[-1] == (cfg.d_model, cfg.vocab_size)  # table.t()
        grads = torch.autograd.grad(logits.square().mean(), leaves,
                                    allow_unused=True)
    assert len(calls) == cfg.n_layers * per_layer + 1
    assert grads[paths.index(next(p for p in paths if "embed" in str(p)))] \
        is not None
