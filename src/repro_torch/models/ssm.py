"""Mamba2 (state-space duality) blocks.

The PyTorch counterpart of ``repro.models.ssm``. Training and prefill
run the chunked SSD algorithm [arXiv:2405.21060 §6]: intra-chunk
quadratic products plus an inter-chunk recurrence over per-chunk
states. Decode carries an O(1) recurrent state (B, nh, hd, N) and a
(d_conv-1)-deep conv ring. Like the reference, this path calls no scan
kernel (``kernels/ssd_scan`` is the kernel API's).

Shapes: d_inner = expand*d_model, nh = d_inner/head_dim, N = d_state,
one group (B/C shared across heads). in_proj packs
[z (di) | x (di) | B (g*N) | C (g*N) | dt (nh)]; x, B, C pass through a
causal depthwise conv (width d_conv) and SiLU. The scan math runs in
float32 whatever the model's dtype; ``A_log``, ``D`` and ``dt_bias``
are float32 leaves.

In a sharded step a block whose heads divide over ``model`` computes
the rank's heads (``ssm_forward(split=True)``): the block's input goes
through ``copy_to_model``, ``out_proj``'s partial through
``reduce_from_model``, and the gated norm's sum of squares is summed
over ``model``; decode and prefill never split, as the reference's
sharded path trains only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.gemm_3xtf32 import linear
from repro_torch.models.layers import Init, as_dtype, f32, rmsnorm

Params = Dict[str, Any]


def init_ssm(init: Init, path: str, d: int, cfg: SSMConfig, dtype,
             lead: Tuple[int, ...] = ()) -> Params:
    di, nh = cfg.d_inner(d), cfg.n_heads(d)
    conv_dim = di + 2 * cfg.n_groups * cfg.d_state
    proj_out = 2 * di + 2 * cfg.n_groups * cfg.d_state + nh
    a_log = torch.log(torch.linspace(1.0, 16.0, nh)).to(init.device)
    return {
        "in_proj": init.normal(f"{path}/in_proj", lead + (d, proj_out),
                               d ** -0.5, dtype),
        "conv_w": init.normal(f"{path}/conv_w", lead + (cfg.d_conv, conv_dim),
                              cfg.d_conv ** -0.5, dtype),
        "conv_b": init.full(lead + (conv_dim,), 0.0, dtype),
        "A_log": a_log.expand(lead + (nh,)).contiguous(),
        "D": init.full(lead + (nh,), 1.0, torch.float32),
        "dt_bias": init.full(lead + (nh,), 0.0, torch.float32),
        "gate_norm": {"scale": init.full(lead + (di,), 1.0, dtype)},
        "out_proj": init.normal(f"{path}/out_proj", lead + (di, d),
                                di ** -0.5, dtype),
    }


def _dims(d: int, cfg: SSMConfig, m: int = 1) -> Tuple[int, int]:
    """(d_inner, heads) a rank computes: of m ranks' equal shares."""
    return cfg.d_inner(d) // m, cfg.n_heads(d) // m


def _split_proj(proj: torch.Tensor, dims: Tuple[int, int], cfg: SSMConfig):
    di = dims[0]
    gN = cfg.n_groups * cfg.d_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * gN],
            proj[..., 2 * di + 2 * gN:])                    # z, [x|B|C], dt


def causal_conv(w: torch.Tensor, b: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. w: (W, C), x: (B, S, C). The taps are
    summed left to right, as the reference's Python ``sum`` does."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i]
    return out + b


def _xbc_split(xc: torch.Tensor, dims: Tuple[int, int], cfg: SSMConfig):
    di, nh = dims
    gN = cfg.n_groups * cfg.d_state
    shp = xc.shape[:-1]
    xs = xc[..., :di].reshape(*shp, nh, cfg.head_dim)
    Bm = xc[..., di:di + gN].reshape(*shp, cfg.n_groups, cfg.d_state)
    Cm = xc[..., di + gN:].reshape(*shp, cfg.n_groups, cfg.d_state)
    return xs, Bm, Cm


# ---------------------------------------------------------------------------
# Core SSD: chunked (training, prefill) and sequential (oracle)
# ---------------------------------------------------------------------------
def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """x:(B,S,nh,hd) dt:(B,S,nh) A:(nh,) Bm/Cm:(B,S,g,N), g == 1.

    Returns (y (B,S,nh,hd), h_final (B,nh,hd,N)), all float32. The
    three-operand contractions run as two products, the small one first,
    so no (B,nc,Q,Q,nh,hd) intermediate exists."""
    Bsz, S, nh, hd = x.shape
    N = Bm.shape[-1]
    S_orig = S
    if S % chunk:
        # pad with dt=0 steps: zero decay and zero input, so the final
        # state and the real positions' outputs are unaffected
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc, Q = S // chunk, chunk
    x, dt = f32(x), f32(dt)
    Bm, Cm = f32(Bm[..., 0, :]), f32(Cm[..., 0, :])          # (B,S,N)

    xc = x.reshape(Bsz, nc, Q, nh, hd)
    dtc = dt.reshape(Bsz, nc, Q, nh)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    dA = dtc * A                                            # (B,nc,Q,nh) <= 0
    cum = torch.cumsum(dA, dim=2)

    # intra-chunk (quadratic)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)            # (B,nc,Q,Q)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,nh)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    # clamp BEFORE exp: masked (i<j) entries have seg > 0 and exp can
    # overflow to inf
    L = torch.where(causal[None, None, :, :, None],
                    torch.exp(seg.clamp(max=0.0)), 0.0)
    xdt = xc * dtc[..., None]                               # (B,nc,Q,nh,hd)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", CB[..., None] * L, xdt)

    # per-chunk input state
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nc,Q,nh)
    S_c = torch.einsum("bcjn,bcjhp->bchpn", Bc,
                       (dtc * decay_to_end)[..., None] * xc)

    # inter-chunk recurrence
    gamma = torch.exp(cum[:, :, -1, :])                     # (B,nc,nh)
    h = torch.zeros(Bsz, nh, hd, N, dtype=torch.float32, device=x.device) \
        if h0 is None else f32(h0)
    starts = []
    for c in range(nc):
        starts.append(h)                                    # entering chunk c
        h = h * gamma[:, c, :, None, None] + S_c[:, c]
    h_starts = torch.stack(starts, dim=1)                   # (B,nc,nh,hd,N)

    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, h_starts) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, nh, hd)
    return y[:, :S_orig], h


def ssd_sequential(x, dt, A, Bm, Cm, h0: Optional[torch.Tensor] = None):
    """Oracle: the step-by-step recurrence; ``ssd_chunked``'s signature
    and returns."""
    Bsz, S, nh, hd = x.shape
    N = Bm.shape[-1]
    x, dt = f32(x), f32(dt)
    Bm, Cm = f32(Bm[..., 0, :]), f32(Cm[..., 0, :])
    h = torch.zeros(Bsz, nh, hd, N, dtype=torch.float32, device=x.device) \
        if h0 is None else f32(h0)
    ys = []
    for t in range(S):
        h, y = _recur(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _recur(h, xt, dtt, A, bt, ct):
    """One step: h (B,nh,hd,N), xt (B,nh,hd), dtt (B,nh), bt/ct (B,N)."""
    h = h * torch.exp(dtt * A)[:, :, None, None] \
        + (dtt[:, :, None] * xt)[..., None] * bt[:, None, None, :]
    return h, (h @ ct[:, None, :, None])[..., 0]


# ---------------------------------------------------------------------------
# Block-level entry points
# ---------------------------------------------------------------------------
def ssm_states_spec(batch: int, d: int, cfg: SSMConfig, dtype
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The decode state's leaves as (shape, dtype): ``h`` float32 and the
    conv ring in the activation dtype."""
    conv_dim = cfg.d_inner(d) + 2 * cfg.n_groups * cfg.d_state
    return {"h": ((batch, cfg.n_heads(d), cfg.head_dim, cfg.d_state),
                  torch.float32),
            "conv": ((batch, cfg.d_conv - 1, conv_dim), dtype)}


def init_ssm_state(batch: int, d: int, cfg: SSMConfig, dtype,
                   device, lead: Tuple[int, ...] = ()) -> Params:
    return {n: torch.zeros(lead + shape, dtype=dt, device=device)
            for n, (shape, dt) in ssm_states_spec(batch, d, cfg,
                                                  dtype).items()}


def _pre_core(p: Params, proj: torch.Tensor, conv_out: torch.Tensor,
              dims: Tuple[int, int], cfg: SSMConfig):
    z, _, dt_raw = _split_proj(proj, dims, cfg)
    xs, Bm, Cm = _xbc_split(F.silu(conv_out), dims, cfg)
    dt = F.softplus(f32(dt_raw) + p["dt_bias"])
    return z, xs, Bm, Cm, dt, -torch.exp(p["A_log"])


def _gated_norm(p: Params, u: torch.Tensor, split: bool) -> torch.Tensor:
    """``rmsnorm(gate_norm, u)``; ``split``: u holds the rank's d_inner /
    m columns, and the mean of squares is over every rank's
    (``tensor_parallel.sum_over_model``)."""
    if not split:
        return rmsnorm(p["gate_norm"], u)
    orig = u.dtype
    uf = f32(u)
    ss = tp.sum_over_model(torch.sum(torch.square(uf), dim=-1, keepdim=True))
    var = ss / (uf.shape[-1] * tp.current().size)
    return as_dtype(uf * torch.rsqrt(var + 1e-5)
                    * f32(p["gate_norm"]["scale"]), orig)


def _post_core(p: Params, y: torch.Tensor, xs: torch.Tensor,
               z: torch.Tensor, x: torch.Tensor,
               split: bool = False) -> torch.Tensor:
    """Skip term, gate, norm and out_proj: y (B,S,nh,hd) f32 -> (B,S,d);
    ``split``: the rank's heads, whose partial ``reduce_from_model``
    sums."""
    y = y + p["D"][:, None] * f32(xs)
    y = y.reshape(*x.shape[:-1], -1).to(x.dtype)
    out = linear(_gated_norm(p, y * F.silu(z), split), p["out_proj"])
    return tp.reduce_from_model(out) if split else out


def _local(p: Params, d: int, cfg: SSMConfig) -> Params:
    """A split block's leaves as this rank reads them (heads h0 .. h1-1,
    ``tensor_parallel.local_heads``): the heads' z, x and dt columns of
    ``in_proj`` and B and C whole; the heads' x channels of the conv and
    B and C; the heads' ``A_log``, ``D`` and ``dt_bias``. ``out_proj``
    and ``gate_norm`` hold the rank's rows already."""
    di, nh = _dims(d, cfg)
    hd, gN = cfg.head_dim, cfg.n_groups * cfg.d_state
    h0, h1 = tp.local_heads(nh)

    def cols(w, spans):
        return torch.cat([w[..., a:b] for a, b in spans], dim=-1)
    xcols = (h0 * hd, h1 * hd)
    conv = [xcols, (di, di + 2 * gN)]
    return {**p, "in_proj": cols(p["in_proj"], [
                xcols, (di + h0 * hd, di + h1 * hd),
                (2 * di, 2 * di + 2 * gN),
                (2 * di + 2 * gN + h0, 2 * di + 2 * gN + h1)]),
            "conv_w": cols(p["conv_w"], conv),
            "conv_b": cols(p["conv_b"], conv),
            "A_log": p["A_log"][h0:h1], "D": p["D"][h0:h1],
            "dt_bias": p["dt_bias"][h0:h1]}


def ssm_forward(p: Params, x: torch.Tensor, d: int, cfg: SSMConfig,
                sequential: bool = False, split: bool = False
                ) -> torch.Tensor:
    """Training-path full-sequence forward (no state). x: (B,S,d).
    ``split`` (a sharded step, ``distributed/tensor_parallel.py``): the
    block computes this rank's heads; ``out_proj`` and ``gate_norm`` hold
    its rows, the other leaves are whole."""
    if split:
        p = _local(p, d, cfg)
        x = tp.copy_to_model(x)
    return _ssm_seq(p, x, d, cfg, sequential, split)[0]


def ssm_prefill(p: Params, x: torch.Tensor, d: int, cfg: SSMConfig
                ) -> Tuple[torch.Tensor, Params]:
    """Forward, and the decode state {h, conv} it leaves."""
    return _ssm_seq(p, x, d, cfg, False)


def _ssm_seq(p, x, d, cfg, sequential, split=False):
    dims = _dims(d, cfg, tp.current().size if split else 1)
    proj = linear(x, p["in_proj"])
    _, xc, _ = _split_proj(proj, dims, cfg)
    z, xs, Bm, Cm, dt, A = _pre_core(
        p, proj, causal_conv(p["conv_w"], p["conv_b"], xc), dims, cfg)
    if sequential:
        y, h = ssd_sequential(xs, dt, A, Bm, Cm)
    else:
        y, h = ssd_chunked(xs, dt, A, Bm, Cm, chunk=cfg.chunk)
    return _post_core(p, y, xs, z, x, split), \
        {"h": h, "conv": xc[:, -(cfg.d_conv - 1):, :]}


def ssm_decode(p: Params, x: torch.Tensor, state: Params, d: int,
               cfg: SSMConfig) -> Tuple[torch.Tensor, Params]:
    """One-token decode. x: (B,1,d); state {h (B,nh,hd,N), conv
    (B,W-1,C)}. The conv sums its taps in ``causal_conv``'s order, so it
    gives the prefill's bits for the same inputs."""
    dims = _dims(d, cfg)
    proj = linear(x, p["in_proj"])                          # (B,1,P)
    _, xc, _ = _split_proj(proj, dims, cfg)
    hist = torch.cat([state["conv"], xc], dim=1)            # (B,W,C)
    w = p["conv_w"]
    conv_out = 0
    for i in range(w.shape[0]):
        conv_out = conv_out + hist[:, i:i + 1, :] * w[i]
    z, xs, Bm, Cm, dt, A = _pre_core(p, proj, conv_out + p["conv_b"], dims,
                                     cfg)
    h, y = _recur(state["h"], f32(xs[:, 0]), dt[:, 0], A,
                  f32(Bm[:, 0, 0, :]), f32(Cm[:, 0, 0, :]))
    return _post_core(p, y[:, None], xs, z, x), \
        {"h": h, "conv": hist[:, 1:, :]}
