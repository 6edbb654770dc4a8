"""Port parity: the plain PyTorch flash-decode (``repro_torch``) against the
JAX package's Pallas kernel (interpret mode) and its jnp oracle, on the
cases of tests/test_kernels_flash_decode.py. Inputs are drawn with numpy
from a seed and handed to both sides. Tolerance 2e-5 (float32; the two
sides sum in different orders).

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against this plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import (flash_decode,  # noqa: E402
                                        flash_decode_ref)
from repro_torch.kernels.flash_decode import COUNTER  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode as t_flash_decode)
from repro_torch.kernels.flash_decode.ops import (  # noqa: E402
    _int32, split_keys)
from repro_torch.kernels.flash_decode.ref import (  # noqa: E402
    flash_decode_ref as t_flash_decode_ref, flash_decode_split_ref)

TOL = 2e-5


def _case(seed, B, H, K, D, n_pages, ps, P, pos=None, live=None):
    """Random pool + a page map with live pages up front and OOB (==
    n_pages) past each row's allocation — the engine's read-map
    contract."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(n_pages, ps, K, D).astype(np.float32)
    vp = rng.randn(n_pages, ps, K, D).astype(np.float32)
    pos = rng.randint(0, P * ps, size=B).astype(np.int32) if pos is None \
        else np.asarray(pos, np.int32)
    pm = np.full((B, P), n_pages, np.int32)
    for b in range(B):
        used = int(pos[b]) // ps + 1
        pm[b, :used] = rng.choice(n_pages, size=used, replace=False)
    live = np.ones(B, np.int32) if live is None else np.asarray(live,
                                                                 np.int32)
    return q, kp, vp, pm, pos, live


def _jax(case, interpret=True):
    return np.asarray(flash_decode(*map(jnp.asarray, case),
                                   interpret=interpret))


def _torch(case):
    return t_flash_decode(*map(torch.tensor, case)).numpy()


CASES = [
    # B, H, K, D, n_pages, ps, P
    (4, 4, 2, 16, 16, 4, 4),      # GQA
    (2, 4, 4, 32, 8, 8, 2),       # MHA
    (3, 8, 1, 16, 32, 4, 8),      # MQA
    (1, 2, 2, 64, 4, 16, 2),      # single row, big pages
    (4, 12, 4, 64, 40, 16, 8),    # the served model's head layout
]


@pytest.mark.parametrize("B,H,K,D,NP,ps,P", CASES)
def test_random_case_matches_pallas_and_oracle(B, H, K, D, NP, ps, P):
    case = _case(B * 100 + H, B, H, K, D, NP, ps, P)
    got = _torch(case)
    assert got.shape == (B, H, D) and got.dtype == np.float32
    assert np.abs(got - _jax(case)).max() < TOL
    assert np.abs(got - np.asarray(
        flash_decode_ref(*map(jnp.asarray, case)))).max() < TOL


def test_ragged_pos_and_dead_rows_give_exact_zeros():
    case = _case(0, 5, 4, 2, 16, 12, 4, 3, pos=[0, 3, 7, 11, 5],
                 live=[1, 1, 0, 1, 0])
    got = _torch(case)
    assert np.abs(got - _jax(case)).max() < TOL
    assert (got[2] == 0.0).all() and (got[4] == 0.0).all()
    assert np.isfinite(got).all()


def test_oob_pages_are_skipped():
    """Map entries >= N read nothing: pointing the unused tail of a row
    at real pages changes nothing (pos masks them), while swapping a
    page the row does read changes the output — on both sides alike."""
    q, kp, vp, pm, pos, live = _case(5, 2, 4, 2, 16, 8, 4, 4, pos=[5, 2])
    base = _torch((q, kp, vp, pm, pos, live))
    alias = pm.copy()
    alias[0, 3], alias[1, 2] = 0, 1
    out = _torch((q, kp, vp, alias, pos, live))
    assert np.abs(out - base).max() == 0.0
    assert np.abs(out - _jax((q, kp, vp, alias, pos, live))).max() < TOL
    swap = pm.copy()
    swap[0, 0] = pm[1, 0]
    out2 = _torch((q, kp, vp, swap, pos, live))
    assert np.abs(out2 - base).max() > 1e-3
    assert np.abs(out2 - _jax((q, kp, vp, swap, pos, live))).max() < TOL
    # a whole row mapped out of bounds behaves like a row with no key
    none = pm.copy()
    none[1, :] = 8
    out3 = _torch((q, kp, vp, none, pos, live))
    assert (out3[1] == 0.0).all()
    assert np.abs(out3 - _jax((q, kp, vp, none, pos, live))).max() < TOL


def test_identity_map_over_dense_cache():
    """The dense slot cache viewed as pages through the identity map (the
    engine's dense flash path) — against the Pallas kernel."""
    B, H, K, D, ps, nb = 3, 4, 2, 16, 4, 4
    rng = np.random.RandomState(8)
    q = rng.randn(B, H, D).astype(np.float32)
    ck = rng.randn(B, ps * nb, K, D).astype(np.float32)
    cv = rng.randn(B, ps * nb, K, D).astype(np.float32)
    pos = np.asarray([3, 9, 15], np.int32)
    live = np.ones(B, np.int32)
    idmap = np.arange(B * nb, dtype=np.int32).reshape(B, nb)
    case = (q, ck.reshape(B * nb, ps, K, D), cv.reshape(B * nb, ps, K, D),
            idmap, pos, live)
    assert np.abs(_torch(case) - _jax(case)).max() < TOL


def test_cpu_path_does_not_count_launches():
    """The launch counter moves only where the CUDA kernel launches; the
    plain version on CPU tensors leaves it alone."""
    COUNTER.reset()
    _torch(_case(1, 2, 4, 2, 16, 8, 4, 2))
    assert COUNTER.count == 0


def test_plain_version_is_the_cpu_dispatch():
    case = tuple(map(torch.tensor, _case(2, 3, 6, 3, 32, 16, 8, 3)))
    assert torch.equal(t_flash_decode(*case), t_flash_decode_ref(*case))


def test_bfloat16_inputs_accumulate_in_float32():
    case = _case(3, 2, 4, 2, 32, 8, 8, 2)
    tq = tuple(torch.tensor(a) for a in case)
    bf = (tq[0].bfloat16(), tq[1].bfloat16(), tq[2].bfloat16()) + tq[3:]
    out = t_flash_decode(*bf)
    assert out.dtype == torch.bfloat16
    ref = t_flash_decode(*(tuple(t.float() for t in bf[:3]) + tq[3:]))
    assert (out.float() - ref).abs().max() < 3e-2


def _split_case(ps):
    """Rows that exercise the split partition: one key, one page, a run
    ending inside a page, a dead row, a hole (a page mapped >= N inside
    the live range), a row with no page at all, a full row."""
    B, H, K, D, P = 7, 6, 2, 32, 4
    n_pages = B * P + 2
    pos = [0, ps - 1, ps + 5, 2 * ps + 7, 3 * ps + 1, P * ps - 1, P * ps - 1]
    live = [1, 1, 1, 0, 1, 1, 1]
    q, kp, vp, pm, pos, live = _case(ps * 7 + 3, B, H, K, D, n_pages, ps, P,
                                     pos=pos, live=live)
    pm[4, 1] = n_pages            # a hole: splits on it see no key
    pm[5, :] = n_pages + 3        # no page at all
    return q, kp, vp, pm, pos, live


@pytest.mark.parametrize("ps", [16, 64, 128])
@pytest.mark.parametrize("split", ["one", 16, 48, 64])
def test_split_merge_matches_pallas_and_oracle(ps, split):
    """The kernel's partition and merge (``flash_decode_split_ref``) for
    one split and runs of 16, 48 and 64 keys: within 2e-5 of the Pallas
    kernel and the oracle, splits past ``pos`` or holding only pages
    mapped >= N merge as nothing, and rows with no key are exact zeros."""
    case = _split_case(ps)
    L = case[3].shape[1] * ps
    got = flash_decode_split_ref(*map(torch.tensor, case),
                                 split=L if split == "one" else split)
    got = got.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - _jax(case)).max() < TOL
    assert np.abs(got - _torch(case)).max() < TOL
    assert (got[3] == 0.0).all() and (got[5] == 0.0).all()


def test_split_merge_bfloat16():
    case = _split_case(16)
    tq = tuple(torch.tensor(a) for a in case)
    bf = (tq[0].bfloat16(), tq[1].bfloat16(), tq[2].bfloat16()) + tq[3:]
    got = flash_decode_split_ref(*bf, split=32)
    assert got.dtype == torch.bfloat16
    ref = t_flash_decode_ref(*bf)
    assert (got.float() - ref.float()).abs().max() < 3e-2


@pytest.mark.parametrize("B,K,L,sms,want", [
    (16, 4, 512, 132, 64),       # the served shapes: 8 splits, 512 CTAs
    (4, 4, 4096, 132, 128),      # long context: 32 splits
    (1, 1, 16, 132, 32),         # shorter than a tile: one split
    (256, 8, 512, 132, 512),     # a full card at one split per row
])
def test_split_length_fills_the_card(B, K, L, sms, want):
    R = split_keys(B, K, L, sms, tile=32)
    assert R == want and R % 32 == 0
    if R > 32:
        assert B * K * -(-L // R) >= 2 * sms


def test_int32_inputs_pass_through_and_others_are_converted():
    pos = torch.arange(8, dtype=torch.int32)
    assert _int32(pos) is pos
    for x in (pos.long(), torch.arange(16, dtype=torch.int32)[::2]):
        got = _int32(x)
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert torch.equal(got, x.to(torch.int32))


# ---------------------------------------------------------------------------
# the CUDA route's shape plan (``ops.plan``): D 256 (paligemma-3b's), a D
# that is not a multiple of 4 zero-padded with the true D's scale, more
# query heads per KV head than a launch takes, B and K cut to the grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,K,D", [(2, 8, 1, 256), (2, 40, 1, 32)])
def test_plain_matches_pallas_at_d256_and_g40(B, H, K, D):
    case = _case(H * D, B, H, K, D, 6, 8, 3)
    assert np.abs(_torch(case) - _jax(case)).max() < TOL


# B, H, K, D, grid limit, query heads per piece (None: the card's)
PLAN_CASES = [(2, 8, 1, 256, 65535, None), (2, 64, 2, 256, 65535, None),
              (3, 80, 2, 30, 2, None), (2, 40, 1, 64, 65535, 7),
              (3, 6, 3, 16, 2, None)]


@pytest.mark.parametrize("B,H,K,D,limit,max_g", PLAN_CASES)
def test_shape_plan_driven_by_the_plain_version(B, H, K, D, limit, max_g):
    """``plan`` with the plain version as its launch equals the plain
    version (2e-5), and each piece it launches has D a multiple of 4, at
    most ``limit`` rows and KV heads and at most ``max_g`` (or 32, the
    card's shared memory permitting) query heads per KV head."""
    from repro_torch.kernels.flash_decode.ops import (_MAX_G, _SMEM_LIMIT,
                                                      plan, smem_bytes)
    case = [torch.tensor(a) for a in _case(B + H + D, B, H, K, D, 6, 8, 3)]
    seen = []

    def launch(q, kp, vp, pm, pos, live, scale):
        assert q.shape[-1] % 4 == 0 and scale == D ** -0.5
        seen.append((q.shape[0], kp.shape[2], q.shape[1] // kp.shape[2]))
        return t_flash_decode_ref(q, kp, vp, pm, pos, live, scale)
    got = plan(launch, *case, limit=limit, max_g=max_g)
    want = t_flash_decode_ref(*case)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < TOL
    for b, k, g in seen:
        assert b <= limit and k <= limit and g <= (max_g or _MAX_G)
        assert smem_bytes(g, D + (-D) % 4, 4) <= _SMEM_LIMIT
    if D == 256 and H // K > 27:      # f32 at D 256: 27 heads fit
        assert len(seen) == 2
    with pytest.raises(ValueError, match="D=260"):
        plan(launch, torch.zeros(1, 1, 260), *(torch.zeros(
            2, 4, 1, 260) for _ in range(2)), *case[3:])
