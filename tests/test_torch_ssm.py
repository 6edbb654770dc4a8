"""Port parity for ``repro_torch.models.ssm`` against ``repro.models.ssm``
on the CPU: the chunked SSD scan against the sequential recurrence and
each against the reference's (S a multiple of the chunk and not, one
chunk, strong decay, a carried-in state), ``causal_conv``, and the block
entry points ``ssm_forward`` / ``ssm_prefill`` / ``ssm_decode`` with
their decode state. Inputs from a numpy seed; float32; 1e-5 where both
sides run the same algorithm, 2e-4 between the chunked scan and the
recurrence (the reference's own tests hold the two at that order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

TOL = 1e-5
SEQ_TOL = 2e-4


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * scale)


def _core_inputs(seed, B=2, S=37, nh=3, hd=8, N=5, dt_scale=1.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, nh, hd).astype(np.float32)
    dt = (np.log1p(np.exp(rng.randn(B, S, nh))) * dt_scale).astype(np.float32)
    A = -np.exp(rng.uniform(0, 2.5, nh)).astype(np.float32)
    Bm = rng.randn(B, S, 1, N).astype(np.float32)
    Cm = rng.randn(B, S, 1, N).astype(np.float32)
    h0 = rng.randn(B, nh, hd, N).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


CORE = [  # (S, chunk, dt scale, carried state)
    (32, 8, 1.0, False), (37, 8, 1.0, False), (5, 16, 1.0, False),
    (37, 8, 25.0, False), (24, 8, 1.0, True)]
CORE_IDS = ["S%chunk=0", "S%chunk!=0", "one-partial-chunk", "strong-decay",
            "h0"]


@pytest.mark.parametrize("S,chunk,dts,with_h0", CORE, ids=CORE_IDS)
def test_ssd_chunked_and_sequential(S, chunk, dts, with_h0):
    x, dt, A, Bm, Cm, h0 = _core_inputs(S + chunk, S=S, dt_scale=dts)
    h0 = h0 if with_h0 else None
    jy, jh = j_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                               chunk=chunk,
                               h0=None if h0 is None else jnp.asarray(h0))
    jsy, jsh = j_ssm.ssd_sequential(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)),
        h0=None if h0 is None else jnp.asarray(h0))
    args = [torch.tensor(a) for a in (x, dt, A, Bm, Cm)]
    th0 = None if h0 is None else torch.tensor(h0)
    ty, th = t_ssm.ssd_chunked(*args, chunk=chunk, h0=th0)
    tsy, tsh = t_ssm.ssd_sequential(*args, h0=th0)
    assert ty.shape == (x.shape[0], S) + x.shape[2:] and ty.dtype == \
        torch.float32
    _close(ty, jy)
    _close(th, jh)
    _close(tsy, jsy)
    _close(tsh, jsh)
    _close(ty, tsy.numpy(), SEQ_TOL)
    _close(th, tsh.numpy(), SEQ_TOL)
    assert torch.isfinite(ty).all() and torch.isfinite(th).all()


def test_causal_conv():
    rng = np.random.RandomState(3)
    w = rng.randn(4, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    x = rng.randn(2, 9, 12).astype(np.float32)
    _close(t_ssm.causal_conv(torch.tensor(w), torch.tensor(b),
                             torch.tensor(x)),
           j_ssm.causal_conv(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x)))


@pytest.fixture(scope="module")
def block():
    """One SSM block of the reduced mamba2-780m with random (not
    zero/one) values in every leaf, on both sides."""
    cfg = get_config("mamba2-780m").reduced()
    tcfg = t_get_config("mamba2-780m").reduced()
    d, s = cfg.d_model, cfg.ssm
    di, nh = s.d_inner(d), s.n_heads(d)
    conv_dim = di + 2 * s.d_state
    rng = np.random.RandomState(7)
    p = {"in_proj": rng.randn(d, 2 * di + 2 * s.d_state + nh) * d ** -0.5,
         "conv_w": rng.randn(s.d_conv, conv_dim) * 0.5,
         "conv_b": rng.randn(conv_dim) * 0.1,
         "A_log": np.log(np.linspace(1.0, 16.0, nh)),
         "D": rng.uniform(0.5, 1.5, nh), "dt_bias": rng.randn(nh) * 0.3,
         "gate_norm": {"scale": rng.uniform(0.5, 1.5, di)},
         "out_proj": rng.randn(di, d) * di ** -0.5}

    def conv(t, f):
        return {k: conv(v, f) if isinstance(v, dict)
                else f(np.asarray(v, np.float32)) for k, v in t.items()}
    return (cfg, tcfg, conv(p, jnp.asarray), conv(p, torch.tensor),
            rng.randn(2, 21, d).astype(np.float32))


@pytest.mark.parametrize("sequential", [False, True],
                         ids=["chunked", "sequential"])
def test_ssm_forward(block, sequential):
    cfg, tcfg, jp, tp, x = block
    want = j_ssm.ssm_forward(jp, jnp.asarray(x), cfg.d_model, cfg.ssm,
                             sequential=sequential)
    _close(t_ssm.ssm_forward(tp, torch.tensor(x), tcfg.d_model, tcfg.ssm,
                             sequential=sequential), want)


def test_ssm_prefill_then_decode(block):
    """Prefill 16 positions, decode the other 5 one at a time: outputs
    and the state (h, conv ring) against the reference's at each step,
    and the decoded outputs against the full-sequence forward."""
    cfg, tcfg, jp, tp, x = block
    d = cfg.d_model
    jy, jst = j_ssm.ssm_prefill(jp, jnp.asarray(x[:, :16]), d, cfg.ssm)
    ty, tst = t_ssm.ssm_prefill(tp, torch.tensor(x[:, :16]), d, tcfg.ssm)
    _close(ty, jy)
    _close(tst["h"], jst["h"])
    _close(tst["conv"], jst["conv"])
    full = t_ssm.ssm_forward(tp, torch.tensor(x), d, tcfg.ssm)
    for t in range(16, x.shape[1]):
        jy, jst = j_ssm.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, d,
                                   cfg.ssm)
        ty, tst = t_ssm.ssm_decode(tp, torch.tensor(x[:, t:t + 1]), tst, d,
                                   tcfg.ssm)
        _close(ty, jy)
        _close(tst["h"], jst["h"])
        _close(tst["conv"], jst["conv"])
        _close(ty, full[:, t:t + 1].numpy(), SEQ_TOL)


def test_states_spec_and_init():
    cfg = get_config("zamba2-7b").reduced()
    tcfg = t_get_config("zamba2-7b").reduced()
    want = j_ssm.ssm_states_spec(3, cfg.d_model, cfg.ssm, jnp.float32)
    got = t_ssm.ssm_states_spec(3, tcfg.d_model, tcfg.ssm, torch.float32)
    assert {k: v[0] for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    st = t_ssm.init_ssm_state(3, tcfg.d_model, tcfg.ssm, torch.bfloat16,
                              "cpu", lead=(2,))
    assert st["h"].dtype == torch.float32 and st["conv"].dtype == \
        torch.bfloat16
    assert st["h"].shape == (2,) + got["h"][0] and not st["h"].any()
