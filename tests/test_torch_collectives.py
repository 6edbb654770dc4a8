"""Port parity for the explicit collectives: ``repro_torch``'s four
functions on a 4-rank gloo world (``distributed/world.py``
``collectives_program``, a (pod 2, data 2) mesh, rendezvous through a
``file://`` under ``tmp_path``) against the unchanged
``repro.distributed.collectives`` run in a JAX subprocess with 4 host
devices under ``jax.shard_map`` / ``jax.set_mesh`` (local blocks
reshaped, not indexed). Both sides take the same seeded inputs, with a
block holding two NaNs and a block of signed zeros.

Tolerances: the reduced results within 1e-6 of max |reference| (the
all-reduces may add the four ranks in another order); the sparsified
payloads, the residuals and so the picks bit for bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import collectives as j_coll  # noqa: E402
from repro_torch.distributed import collectives as t_coll  # noqa: E402
from repro_torch.distributed.world import (collective_inputs,  # noqa: E402
                                           collectives_program, max_rel,
                                           spawn_world)
from repro_torch.kernels.topk_compress.ref import \
    block_topk_flat_ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
BLOCK = 16
JOB = {"n": 1000, "seed": 3, "block": BLOCK, "counts": [1, 5, 0, 7],
       # rank 1: two NaNs in block 2; rank 2: a block of signed zeros and a
       # magnitude tie; rank 3: a tie of opposite signs
       "specials": [(1, 33, float("nan")), (1, 37, float("nan")),
                    *[(2, 64 + i, (-0.0 if i % 2 else 0.0)) for i in range(16)],
                    (2, 96, 1.5), (2, 99, 1.5), (3, 100, 2.5), (3, 101, -2.5)],
       "return_tensors": True}

JAX_SIDE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.collectives import (
    block_topk_sparsify, compressed_reduce, hierarchical_weighted_reduce,
    weighted_psum_reduce)
inp, outp, block = sys.argv[1], sys.argv[2], int(sys.argv[3])
d = np.load(inp)
n = d["g"].shape[1]
g = jnp.asarray(d["g"].reshape(2, 2, n))
r = jnp.asarray(d["r"].reshape(2, 2, n))
c = jnp.asarray(d["c"].reshape(2, 2, 1))
mesh = jax.make_mesh((2, 2), ("pod", "data"))
S = P("pod", "data", None)

def flat(g, c):
    return weighted_psum_reduce({"w": g.reshape(-1)}, c.reshape(()),
                                ("pod", "data"))["w"].reshape(1, 1, -1)

def hier(g, c):
    return hierarchical_weighted_reduce(
        {"w": g.reshape(-1)}, c.reshape(()), intra="data",
        inter="pod")["w"].reshape(1, 1, -1)

def comp(g, r, c):
    red, res = compressed_reduce({"w": g.reshape(-1)}, c.reshape(()),
                                 {"w": r.reshape(-1)}, block, ("pod", "data"))
    return red["w"].reshape(1, 1, -1), res["w"].reshape(1, 1, -1)

with jax.set_mesh(mesh):
    a = jax.shard_map(flat, mesh=mesh, in_specs=(S, S), out_specs=S)(g, c)
    b = jax.shard_map(hier, mesh=mesh, in_specs=(S, S), out_specs=S)(g, c)
    red, res = jax.shard_map(comp, mesh=mesh, in_specs=(S, S, S),
                             out_specs=(S, S))(g, r, c)
sent = np.stack([np.asarray(block_topk_sparsify(
    jnp.asarray(d["g"][i] + d["r"][i]), block)) for i in range(4)])
np.savez(outp, flat=np.asarray(a).reshape(4, n),
         hier=np.asarray(b).reshape(4, n),
         reduced=np.asarray(red).reshape(4, n),
         residual=np.asarray(res).reshape(4, n), sent=sent)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs per rank, the port ranks' results)."""
    tmp = tmp_path_factory.mktemp("coll")
    ins = [collective_inputs(JOB, r, "cpu") for r in range(4)]
    np.savez(tmp / "in.npz",
             g=np.stack([x["g"].numpy() for x in ins]),
             r=np.stack([x["r"].numpy() for x in ins]),
             c=np.array([float(x["c"]) for x in ins], np.float32))
    (tmp / "jax_side.py").write_text(JAX_SIDE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(tmp / "jax_side.py"), str(tmp / "in.npz"),
         str(tmp / "out.npz"), str(BLOCK)],
        capture_output=True, text=True, env=env, timeout=300)
    assert "JAX_SIDE_OK" in proc.stdout, proc.stderr[-3000:]
    ref = dict(np.load(tmp / "out.npz"))
    port = spawn_world(collectives_program, 4, JOB, str(tmp / "world"),
                       device="cpu")
    return ref, port


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", ["flat", "hier", "reduced"])
def test_reduces_match_reference(runs, name):
    ref, port = runs
    for rank in range(4):
        got = port[rank][name]
        want = torch.from_numpy(ref[name][rank])
        assert max_rel(got, want) <= TOL, (name, rank)


def test_sent_residual_and_picks_bitwise(runs):
    """Bit for bit: the sent payloads and residuals, and at each block's
    pick (numpy's argmax of |g + r|, the first NaN where there is one)
    the sent value is the corrected one."""
    ref, port = runs
    pad = (-JOB["n"]) % BLOCK
    for rank in range(4):
        for name in ("sent", "residual"):
            assert np.array_equal(_bits(port[rank][name]),
                                  _bits(ref[name][rank])), (name, rank)
        x = collective_inputs(JOB, rank, "cpu")
        c = np.pad((x["g"] + x["r"]).numpy(), (0, pad)).reshape(-1, BLOCK)
        sent = np.pad(port[rank]["sent"].numpy(), (0, pad)).reshape(-1, BLOCK)
        rows = np.arange(c.shape[0])
        picks = np.argmax(np.abs(c), axis=1)
        assert np.array_equal(_bits(sent[rows, picks]),
                              _bits(c[rows, picks])), rank


def test_rank_checks_and_counters(runs):
    """On every rank: sent = the plain route's bits (on the CPU both
    routes are the plain version; on the card one is kernel 3), sent +
    residual =
    corrected, the reduces within 1e-6 of one-process references; the
    compressed reduce puts 2 x (4 + 4n) bytes on the wire (the count and
    the payload all-reduced) and launches no kernel on the CPU."""
    _, port = runs
    for r in port:
        assert r["sent_equals_plain"] and r["feedback_identity"]
        assert r["kernel_equals_plain"]
        for k in ("flat_rel", "hier_rel", "compressed_rel"):
            assert r[k] <= TOL, (k, r[k])
        assert r["wire_bytes"] == {"all-reduce": 2 * (4 + 4 * JOB["n"])}
        assert r["launches"]["block_topk"] == 0


def test_nan_block_keeps_the_first_nan_as_the_reference():
    """The reference's argmax + one-hot keeps a NaN block's FIRST NaN
    and multiplies the rest by 0 (a second NaN stays NaN, -x becomes
    -0.0); kernel 3's plain version zeros the block. The port's sparsify
    gives the reference's bits."""
    x = np.array([0.5, -3.0, np.nan, 7.0, np.nan, -1.0, 0.0, 2.0,
                  -0.0, 0.0, -0.0, 0.0, 1.0, -4.0, 4.0, 2.0], np.float32)
    want = np.asarray(j_coll.block_topk_sparsify(jnp.asarray(x), 8))
    assert np.isnan(want[2]) and np.isnan(want[4])
    assert _bits(want[[0, 1, 3, 5]]).tolist() == _bits(
        [0.0, -0.0, 0.0, -0.0]).tolist()
    assert want[13] == -4.0 and _bits(want[14]) == _bits(0.0)
    assert _bits(want[8]) == _bits(-0.0)
    t = torch.from_numpy(x)
    assert not torch.isnan(block_topk_flat_ref(t, block_w=8)[:8]).any()
    got = t_coll.block_topk_sparsify(t, 8).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def test_sparsify_matches_reference_on_special_blocks():
    """Blocks drawn from a pool of specials (NaN, +-inf, signed zeros,
    magnitude ties, subnormals) and ordinary values: the port's sparsify
    gives the reference's bits in every block, a ragged tail included."""
    rs = np.random.RandomState(5)
    pool = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 2.0, -2.0, 1e-45,
                     -1e-45], np.float32)
    x = rs.standard_normal(8 * 200 + 5).astype(np.float32)
    special = rs.rand(x.size) < 0.3
    x[special] = pool[rs.randint(len(pool), size=int(special.sum()))]
    x[8 * 7: 8 * 8] = -0.0                          # a block of -0.0
    x[8 * 9: 8 * 10] = 0.0                          # a block of +0.0
    want = np.asarray(j_coll.block_topk_sparsify(jnp.asarray(x), 8))
    got = t_coll.block_topk_sparsify(torch.from_numpy(x), 8).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def test_spawn_world_takes_the_card_unless_told(tmp_path):
    """``spawn_world`` defaults to the card: where there is none it
    raises, as it does for ``cuda:1`` and for ``meta``, before it starts
    a rank; the CPU runs only when named (the tests above)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for dev in ({}, {"device": "cuda:1"}, {"device": "cuda-per-rank"},
                {"device": "meta"}):
        with pytest.raises((RuntimeError, ValueError)):
            spawn_world(collectives_program, 2, JOB, str(tmp_path / "w"),
                        **dev)
    assert not (tmp_path / "w").exists()


def test_sparsify_goes_through_kernel_three(monkeypatch):
    """``block_topk_sparsify`` takes its picks from ``ops.block_topk``
    (kernel 3 on a CUDA tensor, its plain version on the CPU) and from
    nothing else."""
    calls = []
    real = t_coll.block_topk

    def spy(x, *, block_w):
        calls.append((tuple(x.shape), block_w))
        return real(x, block_w=block_w)
    monkeypatch.setattr(t_coll, "block_topk", spy)
    t_coll.block_topk_sparsify(torch.randn(40), 16)
    assert calls == [((40,), 16)]
