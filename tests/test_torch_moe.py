"""Port parity for ``repro_torch.models.moe`` against
``repro.models.moe`` on the CPU: ``capacity``; ``route``'s picks, gates
and aux loss; the ``dispatch_combine`` tensors; ``moe_ffn``,
``moe_ffn_sorted`` and the dense oracle. Inputs come from a numpy seed;
the same weights go to both sides.

Picks and the dispatch/combine tensors' 0/1 structure are EQUAL (drop
sets bit for bit, also at a tight capacity where tokens drop); gates,
aux and layer outputs within 1e-5 (float32). An exact tie in the router
goes to the lower expert index, as ``jax.lax.top_k`` breaks it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

TOL = 1e-5
# (E, k, capacity factor): llama4's top-1 with a shared expert, arctic's
# top-2, and tight capacities where tokens drop
CASES = [(4, 1, 4.0), (4, 2, 4.0), (8, 2, 1.25), (4, 2, 0.5), (16, 1, 1.0)]
IDS = ["top1", "top2", "top2-cf1.25", "top2-drops", "top1-16e-cf1"]


def _cfgs(E, k, cf):
    kw = dict(n_experts=E, experts_per_token=k, d_ff_expert=24,
              capacity_factor=cf)
    return JMoE(**kw), MoEConfig(**kw)


def _inputs(E, seed, B=3, S=11, d=16, ff=24):
    rng = np.random.RandomState(seed)
    p = {"router": rng.randn(d, E).astype(np.float32) * d ** -0.5,
         "w_gate": rng.randn(E, d, ff).astype(np.float32) * d ** -0.5,
         "w_up": rng.randn(E, d, ff).astype(np.float32) * d ** -0.5,
         "w_down": rng.randn(E, ff, d).astype(np.float32) * ff ** -0.5}
    x = rng.randn(B, S, d).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.tensor(v) for k, v in p.items()}, x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("seq", [1, 7, 16, 255])
@pytest.mark.parametrize("E,k,cf", CASES, ids=IDS)
def test_capacity(seq, E, k, cf):
    jc, tc = _cfgs(E, k, cf)
    assert t_moe.capacity(seq, tc) == j_moe.capacity(seq, jc)


@pytest.mark.parametrize("E,k,cf", CASES, ids=IDS)
def test_route(E, k, cf):
    jc, tc = _cfgs(E, k, cf)
    jp, tp, x = _inputs(E, seed=E + k)
    jg, ji, ja = j_moe.route(jp["router"], jnp.asarray(x), jc)
    tg, ti, ta = t_moe.route(tp["router"], torch.tensor(x), tc)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    _close(ta, ja)


def test_router_tie_picks_the_lower_index():
    """Duplicated router columns give bit-equal probabilities: the top-k
    must take them in index order, as ``jax.lax.top_k`` does."""
    jc, tc = _cfgs(8, 2, 4.0)
    rng = np.random.RandomState(5)
    w = rng.randn(16, 8).astype(np.float32)
    w[:, 6] = w[:, 2] = w[:, 5] = 3.0 * np.abs(w).max(axis=1)  # shared top
    x = np.abs(rng.randn(2, 9, 16)).astype(np.float32)
    _, ji, _ = j_moe.route(jnp.asarray(w), jnp.asarray(x), jc)
    _, ti, _ = t_moe.route(torch.tensor(w), torch.tensor(x), tc)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert (ti[..., 0] == 2).all() and (ti[..., 1] == 5).all()


@pytest.mark.parametrize("E,k,cf", CASES, ids=IDS)
def test_dispatch_combine_drop_sets_equal(E, k, cf):
    jc, tc = _cfgs(E, k, cf)
    jp, tp, x = _inputs(E, seed=10 + E + k)
    jg, ji, _ = j_moe.route(jp["router"], jnp.asarray(x), jc)
    cap = j_moe.capacity(x.shape[1], jc)
    jd, jcomb = j_moe.dispatch_combine(jnp.asarray(x), jg, ji, jc, cap)
    # the same picks and gates on both sides: the structure must match
    # bit for bit
    td, tcomb = t_moe.dispatch_combine(
        torch.tensor(x), torch.tensor(np.asarray(jg)),
        torch.tensor(np.asarray(ji)).long(), tc, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tcomb.numpy(), np.asarray(jcomb))
    kept = int(np.asarray(jd).sum())
    if cf < 1.0:
        assert kept < x.shape[0] * x.shape[1] * k       # tokens dropped
    elif cf >= E / k:
        assert kept == x.shape[0] * x.shape[1] * k      # none dropped


@pytest.mark.parametrize("E,k,cf", CASES, ids=IDS)
def test_moe_ffn_einsum_and_sorted(E, k, cf):
    """Both dispatches against the reference's, and against each other:
    the same drop set gives the same layer output."""
    jc, tc = _cfgs(E, k, cf)
    jp, tp, x = _inputs(E, seed=20 + E + k)
    jy, ja = j_moe.moe_ffn(jp, jnp.asarray(x), jc)
    jys, _ = j_moe.moe_ffn_sorted(jp, jnp.asarray(x), jc)
    ty, ta = t_moe.moe_ffn(tp, torch.tensor(x), tc)
    tys, tas = t_moe.moe_ffn_sorted(tp, torch.tensor(x), tc)
    _close(ty, jy)
    _close(tys, jys)
    _close(ta, ja)
    _close(tas, ja)
    _close(tys, ty.numpy())
    # dropped tokens pass through as zeros on both
    zero_rows = np.all(np.asarray(jy) == 0, axis=-1)
    assert np.array_equal(np.all(ty.numpy() == 0, axis=-1), zero_rows)


@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (8, 2)])
def test_dense_oracle(E, k):
    """With generous capacity nothing drops, so the dispatch-combine
    layer equals running every expert on every token."""
    jc, tc = _cfgs(E, k, float(E))
    jp, tp, x = _inputs(E, seed=30 + E + k)
    want = j_moe.moe_ffn_dense_ref(jp, jnp.asarray(x), jc)
    _close(t_moe.moe_ffn_dense_ref(tp, torch.tensor(x), tc), want)
    _close(t_moe.moe_ffn(tp, torch.tensor(x), tc)[0], want)


def test_bf16_layer_keeps_an_f32_router():
    """In a bf16 layer the router still routes in float32: the picks
    are those of the float32 router on the bf16 activations."""
    tc = _cfgs(4, 2, 4.0)[1]
    _, tp, x = _inputs(4, seed=41)
    xb = torch.tensor(x).to(torch.bfloat16)
    bp = {k: (v if k == "router" else v.to(torch.bfloat16))
          for k, v in tp.items()}
    y, aux = t_moe.moe_ffn(bp, xb, tc)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _, idx, _ = t_moe.route(tp["router"], xb.float(), tc)
    _, idx_b, _ = t_moe.route(bp["router"], xb, tc)
    assert torch.equal(idx, idx_b)
    ys, _ = t_moe.moe_ffn_sorted(bp, xb, dataclasses.replace(tc, impl="sort"))
    assert (ys.float() - y.float()).abs().max() <= 2 ** -6 * y.float().abs().max()
