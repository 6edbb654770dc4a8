"""Worlds of ranks on one host, and the programs they run.

``spawn_world`` starts ``nprocs`` processes with ``torch.multiprocessing``
(start method ``spawn``), each joining a ``torch.distributed`` world
through a ``file://`` rendezvous, and runs one program per rank. A
program is a module-level function here (spawned processes import it by
name); it reads its job from a file and writes one result file per rank,
so tests and ``chip_smoke.py`` drive the same code on the CPU (gloo) and
on the card (gloo over CUDA tensors, or NCCL with one card per rank).

  - ``collectives_program``: the four collectives of
    ``distributed/collectives.py`` on every rank's seeded inputs over a
    (pod 2, data 2)-shaped mesh, with one-process references, the
    sparsify's plain version on the same tensors, kernel 3's launches and
    the wire bytes by op;
  - ``mesh_sgd_program``: ``ElasticMeshSGD`` with ``in_shardings`` /
    ``out_shardings`` over a mesh, under a churn schedule: every step's
    metrics, wire bytes by op and host ms; the stored bytes; peak memory;
    the gathered params (from rank 0, to a file);
  - ``tensor_parallel_program``: the functions of
    ``distributed/tensor_parallel.py`` and the split MLP, attention and
    Mamba2 blocks on each rank's parts of full tensors over a (model
    world) mesh, with their gradients.

Ranks on one card share it (gloo copies each collective's bytes through
host memory); their times are no NCCL or NVLink figures.
"""
from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.core.flatbuf import tree_leaves, tree_map
from repro_torch.core.mesh_engine import ElasticMeshSGD
from repro_torch.distributed import (comm_analysis, sharded_step,
                                     tensor_parallel)
from repro_torch.distributed.activation_sharding import activation_sharding
from repro_torch.distributed.collectives import (
    block_topk_sparsify, compressed_reduce, hierarchical_weighted_reduce,
    reference_picks, weighted_psum_reduce)
from repro_torch.distributed.sharding import (batch_axis, batch_spec,
                                              param_specs, to_shardings)
from repro_torch.kernels.runtime import (COUNTERS, reset_counters,
                                        resolve_device)
from repro_torch.kernels.topk_compress.ops import block_topk
from repro_torch.kernels.topk_compress.ref import block_topk_flat_ref
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.optim import get_optimizer
from repro_torch.train.step import build_train_step, make_train_state


def _entry(rank: int, program: Callable, nprocs: int, backend: str,
           init_method: str, device: str, threads: int, job_path: str,
           out_dir: str) -> None:
    torch.set_num_threads(threads)
    kw = {}
    if device == PER_RANK:               # one card per rank (NCCL)
        dev = resolve_device(torch.device("cuda", rank))
        kw["device_id"] = dev
    else:                                # every rank on the one device
        dev = _world_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=nprocs, rank=rank, **kw)
    try:
        # the job and the results are files this module writes itself
        out = program(rank, nprocs, torch.load(job_path, weights_only=False),
                      dev)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


PER_RANK = "cuda-per-rank"


def _world_device(device: str) -> torch.device:
    """Every rank's device: ``resolve_device``'s (CUDA raises where there
    is none; a bare ``"cuda"`` is card 0); ``meta`` cannot run a world."""
    dev = resolve_device(device)
    if dev.type == "meta":
        raise ValueError("device='meta': a world of ranks needs a device "
                         "that computes")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def spawn_world(program: Callable, nprocs: int, job: Dict[str, Any],
                workdir: str, *, backend: str = "gloo",
                device: str = "cuda", threads: int = 1
                ) -> List[Dict[str, Any]]:
    """Run ``program(rank, world, job, device)`` on ``nprocs`` spawned
    ranks and return their results in rank order. ``device``: any
    ``resolve_device`` takes but ``"meta"`` (``"cuda"``: every rank on
    card 0; raises without CUDA; the CPU only when named), or
    ``"cuda-per-rank"`` (rank r on card r, for NCCL). The rendezvous and
    the job and result files live under ``workdir`` (a fresh directory
    per world). Raises if any rank fails."""
    if device == PER_RANK:
        resolve_device("cuda")
        if torch.cuda.device_count() < nprocs:
            raise RuntimeError(f"device={PER_RANK!r} needs {nprocs} cards; "
                               f"{torch.cuda.device_count()} are visible")
    else:
        _world_device(device)
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    job_path = str(work / "job.pt")
    torch.save(job, job_path)
    init = f"file://{work.resolve() / 'rendezvous'}"
    mp.start_processes(
        _entry, args=(program, nprocs, backend, init, device, threads,
                      job_path, str(work)),
        nprocs=nprocs, join=True, start_method="spawn")
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(nprocs)]


def chain_program(rank: int, world: int, job: Dict[str, Any],
                  dev: torch.device) -> List[Any]:
    """Each ``(program, job)`` of ``job["chain"]`` in turn, in one world
    (a world costs seconds to start)."""
    return [program(rank, world, j, dev) for program, j in job["chain"]]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the four collectives
# ---------------------------------------------------------------------------
COLLECTIVES_MESH = ((2, 2), ("pod", "data"))


def collective_inputs(job: Dict[str, Any], rank: int,
                      device: Union[str, torch.device] = "cuda"
                      ) -> Dict[str, Any]:
    """Rank ``rank``'s seeded inputs on ``device`` (drawn by that
    device's generator): a gradient sum ``g`` and a residual ``r`` of
    ``job["n"]`` float32 entries and a sample count ``c``. Each of the
    job's ``specials`` (rank, index, value) sets ``g`` there to the value
    and ``r`` to -0.0, so ``g + r`` holds the value bit for bit (NaN, a
    signed zero)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(job["seed"] + rank)
    g = torch.randn(job["n"], generator=gen, device=device)
    r = 0.1 * torch.randn(job["n"], generator=gen, device=device)
    for rk, idx, val in job.get("specials", ()):
        if rk == rank:
            g[idx] = val
            r[idx] = -0.0
    return {"g": g, "r": r,
            "c": torch.tensor(float(job["counts"][rank]), device=device)}


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| over the entries where b is finite; inf where
    the two differ in their NaN or infinite entries."""
    fin = torch.isfinite(b)
    if not torch.equal(torch.isnan(a), torch.isnan(b)) or not torch.equal(
            a[~fin & ~torch.isnan(b)], b[~fin & ~torch.isnan(b)]):
        return float("inf")
    if not fin.any():
        return 0.0
    return float((a[fin] - b[fin]).abs().max()
                 / b[fin].abs().max().clamp_min(1e-30))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def collectives_program(rank: int, world: int, job: Dict[str, Any],
                        dev: torch.device) -> Dict[str, Any]:
    """The four collectives over ``COLLECTIVES_MESH`` (flat over ("pod",
    "data"), hierarchical data then pod, compressed over both at
    ``job["block"]``), each rank on its own inputs; kernel 3's launches
    and the wire bytes counted around the compressed reduce alone; the
    host ms of that call, and of the sparsify's kernel and post-pass
    alone.
    ``job["return_tensors"]`` sends the outputs back (small ``n`` only);
    the checks against one-process references run here either way."""
    mesh = Mesh(*COLLECTIVES_MESH)
    block = job["block"]
    ins = [collective_inputs(job, r, dev) for r in range(world)]
    mine = ins[rank]
    out: Dict[str, Any] = {"rank": rank}
    with mesh:
        flat = weighted_psum_reduce({"w": mine["g"]}, mine["c"],
                                    ("pod", "data"))["w"]
        hier = hierarchical_weighted_reduce({"w": mine["g"]}, mine["c"],
                                            intra="data", inter="pod")["w"]
        _sync(dev)
        reset_counters()
        comm_analysis.reset()
        t0 = time.perf_counter()
        red, res = compressed_reduce({"w": mine["g"]}, mine["c"],
                                     {"w": mine["r"]}, block,
                                     ("pod", "data"))
        red, res = red["w"], res["w"]
        _sync(dev)
        out["compressed_ms"] = 1e3 * (time.perf_counter() - t0)
        out["launches"] = {k: c.count for k, c in COUNTERS.items()}
        out["wire_bytes"] = comm_analysis.collective_bytes()
        # checks on the rank's device: one-process references of every
        # rank's inputs, the sparsify's plain version on the same tensors
        corrected = mine["g"] + mine["r"]
        # block_topk_sparsify's two parts timed apart, kernel 3 and its
        # post-pass (best of 3; the ranks share the card as in the call)
        kernel_ms, picks_ms = [], []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            kept = block_topk(corrected, block_w=block)
            _sync(dev)
            t1 = time.perf_counter()
            reference_picks(corrected, kept)
            _sync(dev)
            kernel_ms.append(1e3 * (t1 - t0))
            picks_ms.append(1e3 * (time.perf_counter() - t1))
        del kept
        out["kernel_ms"] = min(kernel_ms)
        out["picks_ms"] = min(picks_ms)
        sent = block_topk_sparsify(corrected, block)
        plain = reference_picks(corrected,
                                block_topk_flat_ref(corrected, block_w=block))
        out["sent_equals_plain"] = _same_bits(sent, plain)
        out["kernel_equals_plain"] = _same_bits(
            block_topk(corrected, block_w=block),
            block_topk_flat_ref(corrected, block_w=block))
        recon = sent + res
        out["feedback_identity"] = max_rel(recon, corrected) == 0.0
        gs = torch.stack([x["g"] for x in ins])
        cs = torch.stack([x["c"] for x in ins])
        mean = gs.sum(0) / cs.sum().clamp(min=1.0)
        out["flat_rel"] = max_rel(flat, mean)
        out["hier_rel"] = max_rel(hier, mean)
        sents = [reference_picks(c, block_topk_flat_ref(c, block_w=block))
                 for c in (gs + torch.stack([x["r"] for x in ins]))]
        want = torch.stack(sents).sum(0) / cs.sum().clamp(min=1.0)
        out["compressed_rel"] = max_rel(red, want)
        if job.get("return_tensors"):
            out.update(flat=flat.cpu(), hier=hier.cpu(), reduced=red.cpu(),
                       residual=res.cpu(), sent=sent.cpu())
    return out


# ---------------------------------------------------------------------------
# the sharded elastic mesh engine
# ---------------------------------------------------------------------------
def _batches(run: Dict[str, Any], cfg, dev: torch.device):
    """``run["batches"]``: a list of numpy batch dicts (cycled), or a
    seed for ``launch.train.data_stream``."""
    src = run["batches"]
    if isinstance(src, int):
        from repro_torch.launch.train import data_stream
        yield from data_stream(cfg.vocab_size, run["batch"], run["seq"], src,
                               device=dev)
        return
    i = 0
    while True:
        yield {k: torch.as_tensor(v, device=dev)
               for k, v in src[i % len(src)].items()}
        i += 1


def mesh_sgd_program(rank: int, world: int, job: Dict[str, Any],
                     dev: torch.device) -> Dict[str, Any]:
    """``job["runs"]`` in turn on ``job["mesh"]``, each ``ElasticMeshSGD``
    over ``build_train_step(cfg, optimizer, remat=False)`` with the
    ``param_specs(state, cfg, mesh, "train")`` shardings, inside
    ``activation_sharding(batch axes)``. A run's keys (a job-level key is
    every run's default): ``arch`` (``reduced``: its ``.reduced()``),
    ``batch``, ``seq``, ``n_workers``, ``batches`` (``_batches``),
    ``optimizer`` (name, kwargs), ``steps``, ``churn`` ({step: [(kind,
    worker)]}), ``params`` (a ``torch.save``d tree, or None for
    ``init_params`` from ``seed``), ``timed`` (synchronize before each
    collective and sum its host time), ``gather`` (a path: rank 0 saves
    the gathered params there; every rank gathers, it is collective),
    ``n_layers`` (a depth cut), ``f32`` (params and activations in
    float32), ``moe_impl`` (``"einsum"`` or ``"sort"``), ``remat``
    (default False). Per step a run reports the wire bytes by op, the
    host ms, the collectives' host ms, and apart the gathers', the
    activation collectives' (``tensor_parallel``; the Mamba2 norms' sums
    of squares among them, and apart) and the partial leaves' gradient
    all-reduces (``sharded_step.PARTIAL``)."""
    mesh = Mesh(*job["mesh"])
    results = []
    with mesh:
        for run in job["runs"]:
            run = {**job, **run}
            results.append(_mesh_run(rank, mesh, run, dev))
    return {"rank": rank, "runs": results}


def _mesh_run(rank: int, mesh: Mesh, run: Dict[str, Any],
              dev: torch.device) -> Dict[str, Any]:
    cfg = get_config(run["arch"])
    if run.get("reduced"):
        cfg = cfg.reduced()
    if run.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=run["n_layers"])
    if run.get("f32"):
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  activ_dtype="float32")
    if run.get("moe_impl"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl=run["moe_impl"]))
    B = run["batch"]
    opt = get_optimizer(run["optimizer"][0], **run["optimizer"][1])
    if run.get("params"):
        params = tree_map(lambda x: x.to(dev),
                          torch.load(run["params"], weights_only=False))
    else:
        params = tf.init_params(cfg, seed=run.get("seed", 0), device=dev)
    state = make_train_state(params, opt)
    sh = to_shardings(param_specs(state, cfg, mesh, "train"), mesh)
    with activation_sharding(batch_axis(batch_spec(mesh, B))):
        eng = ElasticMeshSGD(
            train_step=build_train_step(cfg, opt,
                                        remat=run.get("remat", False)),
            state=state, n_workers=run["n_workers"], global_batch=B,
            jit_kwargs=dict(in_shardings=(sh, None),
                            out_shardings=(sh, None)))
        del params, state
        stored = sum(x.numel() * x.element_size()
                     for x in tree_leaves(eng.state))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        stream = _batches(run, cfg, dev)
        comm_analysis.COUNTER.sync = run.get("timed", False)
        host_ms, wire, comm_ms, gather_ms, act_ms = [], [], [], [], []
        norm_ms, partial_ms = [], []
        reset_counters()
        try:
            for i in range(run["steps"]):
                for kind, w in run.get("churn", {}).get(i, []):
                    getattr(eng, kind)(w)
                b = next(stream)
                comm_analysis.reset()
                tensor_parallel.reset_activation()
                sharded_step.reset_partial()
                _sync(dev)
                t = time.perf_counter()
                eng.step(b)                 # the metrics' floats sync
                host_ms.append(1e3 * (time.perf_counter() - t))
                wire.append(comm_analysis.collective_bytes())
                seconds = comm_analysis.COUNTER.seconds
                comm_ms.append(1e3 * sum(seconds.values()))
                gather_ms.append(1e3 * seconds.get("all-gather", 0.0))
                act_ms.append(1e3 * tensor_parallel.ACTIVATION["seconds"])
                norm_ms.append(
                    1e3 * tensor_parallel.ACTIVATION["norm_seconds"])
                partial_ms.append(1e3 * sharded_step.PARTIAL["seconds"])
        finally:
            comm_analysis.COUNTER.sync = False
        out = {"history": eng.history, "host_ms": host_ms,
               "wire_bytes": wire, "comm_ms": comm_ms,
               "gather_ms": gather_ms, "act_ms": act_ms,
               "norm_ms": norm_ms, "partial_ms": partial_ms,
               "stored_bytes": stored,
               "launches": {k: c.count for k, c in COUNTERS.items()},
               "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else 0)}
        if run.get("gather"):
            full = eng.gather_state()["params"]
            if rank == 0:
                torch.save(tree_map(lambda x: x.cpu(), full), run["gather"])
            del full
    del eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# tensor parallelism over (model world)
# ---------------------------------------------------------------------------
def _local_part(name: str, w: torch.Tensor, world: int, index: int,
                kv_split: bool = True) -> torch.Tensor:
    """Rank ``index``'s part of a parameter ``name`` split over ``model``
    (``tensor_parallel.TP_DIM``); replicated KV heads unless
    ``kv_split``, and every other leaf, whole."""
    rel = tensor_parallel.TP_DIM.get(name)
    if rel is None or (name in tensor_parallel.KV_REPLICATED
                       and not kv_split):
        return w.clone()
    dim = w.dim() + rel
    n = w.shape[dim] // world
    return w.narrow(dim, index * n, n).clone()


def _tp_case(kind: str, c: Dict[str, Any], world: int, index: int
             ) -> Dict[str, Any]:
    """One case on this rank: (output, gradients of ``sum(out * g)``
    with respect to the inputs and the rank's parameter parts)."""
    leaf = {}

    def grad_of(name, t):
        leaf[name] = t.detach().clone().requires_grad_(True)
        return leaf[name]
    if kind == "copy_reduce":
        c_r = float(index + 1)
        y = tensor_parallel.reduce_from_model(grad_of("a", c["x"]) * c_r)
        z = tensor_parallel.copy_to_model(grad_of("b", c["x"])) * c_r
        out = torch.stack([y, z])
    elif kind == "sum_over":
        c_r = float(index + 1)
        out = tensor_parallel.sum_over_model(grad_of("a", c["x"]) * c_r) * c_r
    elif kind == "embed":
        table = _local_part("embed", c["table"], world, index)
        out = layers.embed(grad_of("table", table), c["tokens"], True)
    elif kind == "xent":
        n = c["logits"].shape[-1] // world
        z = c["logits"].narrow(-1, index * n, n)
        nll, count = layers.softmax_xent(grad_of("logits", z), c["labels"],
                                         c.get("mask"))
        out = torch.stack([nll, count])
    elif kind == "mlp":
        p = {k: grad_of(k, _local_part(k, w, world, index))
             for k, w in c["p"].items()}
        out = layers.mlp(p, grad_of("x", c["x"]), c["act"], True)
    elif kind == "ssm":
        # a Mamba2 block: out_proj's rows and gate_norm's scale are the
        # rank's heads' when ``split``, every other leaf whole
        p = {}
        for k, w in c["p"].items():
            t = w["scale"] if isinstance(w, dict) else w
            dim = tensor_parallel.SSM_TP_DIM.get(
                "scale" if isinstance(w, dict) else k)
            if c["split"] and dim is not None:
                n = t.shape[dim] // world
                t = t.narrow(dim, index * n, n)
            t = grad_of(k, t.clone())
            p[k] = {"scale": t} if isinstance(w, dict) else t
        out = ssm_mod.ssm_forward(p, grad_of("x", c["x"]), c["d"], c["cfg"],
                                  split=c["split"])
    else:
        p = {}
        for k, w in c["p"].items():
            if isinstance(w, dict):
                p[k] = {"scale": grad_of(k, w["scale"])}
            else:
                p[k] = grad_of(k, _local_part(k, w, world, index,
                                              c["kv_split"]))
        out = attn_mod.attention(p, grad_of("x", c["x"]), c["positions"],
                                 causal=True, split=True,
                                 kv_split=c["kv_split"])
    grads = torch.autograd.grad((out * c["g"]).sum(), list(leaf.values()),
                                allow_unused=True)
    return {"out": out.detach(),
            "grads": {k: g for k, g in zip(leaf, grads) if g is not None}}


def _tensors_to(tree, dev: torch.device):
    """A nested dict with its tensors on ``dev`` (other values as they
    are)."""
    if isinstance(tree, dict):
        return {k: _tensors_to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def tensor_parallel_program(rank: int, world: int, job: Dict[str, Any],
                            dev: torch.device) -> Dict[str, Any]:
    """``job["cases"]`` [(kind, inputs)] on mesh (model ``world``),
    inside ``sharded_compute`` with the head split (so
    ``layers.softmax_xent`` hands off to ``vocab_parallel_xent``): each
    case's output, gradients and activation collectives on this rank
    (``_tp_case``), and the activation collectives' count."""
    mesh = Mesh((world,), ("model",))
    out: Dict[str, Any] = {"rank": rank, "cases": []}
    with mesh, tensor_parallel.sharded_compute(mesh, (), (), head=True):
        tensor_parallel.reset_activation()
        for kind, c in job["cases"]:
            before = tensor_parallel.ACTIVATION["calls"]
            res = _tp_case(kind, _tensors_to(c, dev), world,
                           mesh.chunk_index("model", rank))
            res["calls"] = tensor_parallel.ACTIVATION["calls"] - before
            out["cases"].append(_tensors_to(res, torch.device("cpu")))
        out["calls"] = tensor_parallel.ACTIVATION["calls"]
    return out


def same_everywhere(results: List[Dict[str, Any]], key: str = "history"
                    ) -> bool:
    """Every rank's runs report the same ``key``."""
    first = [r[key] for r in results[0]["runs"]]
    return all([r[key] for r in res["runs"]] == first for res in results)

