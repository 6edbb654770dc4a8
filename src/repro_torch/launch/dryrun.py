"""Multi-pod dry-run: per-rank bytes, collective bytes and roofline terms
for every (arch x shape x mesh), without allocating (the counterpart of
``repro.launch.dryrun``).

For the requested architecture / input shape / mesh this script:
  1. builds the mesh (the production (data 16, model 16) / (pod 2,
     data 16, model 16), or ``--mesh``) as a description — no process
     group, no device;
  2. builds the params (+ optimizer state for train) and the inputs on
     the ``meta`` device (shapes and dtypes only);
  3. shards them by the port's rules (``distributed/sharding.py``: train
     params and state per ``param_specs(.., "train")``, serving params per
     ``"serve"``, batches per ``batch_spec``, caches per ``cache_specs``)
     and reports from each rank's local shapes:
       - ``memory.argument_bytes`` / ``output_bytes``: the step's inputs
         (state or params, and the batch or the token, position and
         cache) and outputs (the new state and four f32 metrics; or the
         last-token f32 logits and the cache), per rank;
       - ``collective_bytes_per_chip`` / ``collectives``: one train
         step of ``distributed/sharded_step.py`` (``remat`` unless
         ``--no-remat``), reckoned by ``step_collectives`` from the
         specs and the activation shape (B / batch split, S, d) with the
         same ``wire_bytes`` its calls count; prefill and decode carry
         the gathers of the ``serve``-mode shards;
       - ``model_flops_per_chip``, ``n_params`` / ``n_active_params``:
         the reference's formulas (6 or 2 x active params x tokens, over
         the mesh's ranks); ``flops_per_chip``: a train step's work over
         the ranks the batch is split over, where each leaf's share is
         divided by the ``model`` ranks its block splits over
         (``train_flops_share``); a serving step's is replicated over
         ``model``, as the port serves on one device;
       - ``roofline``: ``roofline_terms`` with the H100 constants of
         ``launch/mesh.py``, the memory term from the argument bytes;
  4. emits one JSON line.

No counterpart, so left out: XLA's ``memory_analysis`` ``temp_bytes``
and generated code, ``raw_scan_counted`` and the cost probes, the HLO op
counts, and ``lower_s`` / ``compile_s`` / ``probe_s``. Nor do the
reference's ``remat``, ``donate`` and ``probe`` switches select anything
here but ``remat``: its ``--no-donate`` and ``--no-probe`` flags parse,
in one group that is ignored, so its command lines run unchanged;
``--no-remat`` reckons the collectives of a step without the recompute.
Skips are the reference's ``supports``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k [--multi-pod] [--mesh 2,2] [--json out.jsonl]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Any, Dict, Union

import torch

from repro_torch.configs import ArchConfig, get_config, get_shape
from repro_torch.configs.shapes import SHAPE_REGISTRY, InputShape
from repro_torch.core.flatbuf import tree_map, tree_paths
from repro_torch.distributed.comm_analysis import roofline_terms
from repro_torch.distributed.sharded_step import (ComputePlan, compute_plan,
                                                  step_collectives)
from repro_torch.distributed.sharding import (NamedSharding, P, batch_axis,
                                              batch_spec, cache_specs,
                                              local_shape, param_specs,
                                              parse_layout)
from repro_torch.distributed.tensor_parallel import (KV_REPLICATED,
                                                     kv_heads_read)
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16, Mesh,
                                     make_production_mesh)
from repro_torch.launch.specs import effective_config, input_specs, supports
from repro_torch.models import transformer as tf
from repro_torch.optim import get_optimizer
from repro_torch.train.step import make_train_state

METRICS_BYTES = 4 * 4            # loss, tokens, aux_loss, total_loss (f32)


def build_mesh(args) -> Mesh:
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split(","))
        names = ("pod", "data", "model")[-len(dims):]
        return Mesh(dims, names)
    return make_production_mesh(multi_pod=args.multi_pod)


def batch_shardings(batch_tree, mesh: Mesh, B: int, layout=frozenset()):
    baxis = batch_axis(batch_spec(mesh, B, layout))
    return tree_map(lambda leaf: NamedSharding(
        mesh, P(baxis, *(None,) * (leaf.dim() - 1))), batch_tree)


def probe_config(cfg, units: int):
    """Reduced-LAYER variant of an effective config (full width/vocab/batch).
    Hybrid units are super-blocks; audio units pair one encoder + one
    decoder layer."""
    if cfg.arch_type == "hybrid":
        return dataclasses.replace(
            cfg, n_layers=cfg.hybrid_attn_period * units)
    if cfg.arch_type == "audio":
        return dataclasses.replace(cfg, n_layers=units,
                                   n_encoder_layers=units)
    return dataclasses.replace(cfg, n_layers=units)


def full_units(cfg) -> int:
    if cfg.arch_type == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_period
    return cfg.n_layers


def _apply_layout_cfg(cfg, layout):
    if "moe_sort" in layout and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl="sort"))
    return cfg


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty(
        (), dtype=dtype, device="meta").element_size()


def local_bytes(tree, specs, mesh: Mesh) -> int:
    """One rank's bytes of ``tree`` stored per ``specs``."""
    spec_of = dict(tree_paths(specs))
    return sum(_nbytes(local_shape(x.shape, spec_of[p], mesh), x.dtype)
               for p, x in tree_paths(tree))


def _batch_bytes(batch, mesh: Mesh, B: int, layout) -> int:
    sh = batch_shardings(batch, mesh, B, layout)
    return local_bytes(batch, tree_map(lambda s: s.spec, sh), mesh)


def train_flops_share(params, plan: ComputePlan, cfg, m: int) -> float:
    """The share of a train step's model FLOPs that one rank of a batch
    group computes: each leaf's active parameters (an expert leaf's
    times k / E) weighted by 1 / m where its block splits over ``model``,
    by the share of KV heads the rank's query heads read for a
    replicated KV projection in a split attention, else 1."""
    moe = cfg.moe
    num = den = 0.0
    for path, leaf in tree_paths(params):
        a = float(leaf.numel())
        if moe is not None and "moe" in path[:-1] and path[-1] != "router":
            a *= moe.experts_per_token / moe.n_experts
        share = 1.0
        if path in plan.split:
            share = 1.0 / m
        elif path in plan.partial:
            share = 1.0 / m
            if path[-1] in KV_REPLICATED:
                heads, _ = kv_heads_read(0, cfg.n_heads // m,
                                         cfg.n_heads // cfg.n_kv_heads)
                share = len(heads) / cfg.n_kv_heads
        num += share * a
        den += a
    return num / den


def run_dryrun(arch: Union[str, ArchConfig], shape: Union[str, InputShape], *,
               multi_pod: bool = False, mesh: Mesh = None,
               optimizer_name: str = "adagrad",
               layout: str = "baseline", remat: bool = True
               ) -> Dict[str, Any]:
    """One (arch, shape, mesh)'s JSON record (module docstring). ``arch``
    is a registered name or an ``ArchConfig`` (a ``.reduced()`` one, say),
    ``shape`` a registered shape's name or an ``InputShape``;
    ``optimizer_name`` any of ``optim.get_optimizer``'s; ``remat``: the
    train step recomputes each block in backward."""
    lay = parse_layout(layout)
    cfg0 = get_config(arch) if isinstance(arch, str) else arch
    arch = cfg0.name
    shape = get_shape(shape) if isinstance(shape, str) else shape
    ok, reason = supports(cfg0, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "skipped": True,
                "reason": reason}
    cfg = _apply_layout_cfg(effective_config(cfg0, shape), lay)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    specs = input_specs(cfg0, shape)
    B = shape.global_batch
    bentry = batch_axis(batch_spec(mesh, B, lay))
    split = mesh.axes_size(bentry)
    params_abs = tf.abstract_params(cfg)
    memory: Dict[str, int] = {}
    share = 1.0
    if shape.kind == "train":
        opt = get_optimizer(optimizer_name)
        state_abs = make_train_state(params_abs, opt)
        st_specs = param_specs(state_abs, cfg, mesh, "train", lay)
        memory["state_bytes"] = local_bytes(state_abs, st_specs, mesh)
        memory["argument_bytes"] = memory["state_bytes"] + _batch_bytes(
            specs["batch"], mesh, B, lay)
        memory["output_bytes"] = memory["state_bytes"] + METRICS_BYTES
        coll = step_collectives(params_abs, st_specs["params"], mesh, bentry,
                                act=(cfg, B // split, shape.seq_len),
                                remat=remat)
        plan = compute_plan([(p, x.dim()) for p, x in tree_paths(
            params_abs)], st_specs["params"], mesh)
        share = train_flops_share(params_abs, plan, cfg,
                                  mesh.shape.get("model", 1))
    else:
        p_specs = param_specs(params_abs, cfg, mesh, "serve", lay)
        memory["param_bytes"] = local_bytes(params_abs, p_specs, mesh)
        logits = _nbytes((B // split, 1, cfg.vocab_size), torch.float32)
        if shape.kind == "prefill":
            cache = tf.init_decode_cache(cfg, B, shape.seq_len,
                                         device="meta")
            inputs = _batch_bytes(specs["batch"], mesh, B, lay)
        else:
            cache = specs["cache"]
            inputs = (_batch_bytes({"t": specs["token"]}, mesh, B, lay)
                      + _nbytes((), torch.int32))
        cache_bytes = local_bytes(
            cache, cache_specs(cache, cfg, mesh, B, lay), mesh)
        memory["cache_bytes"] = cache_bytes
        memory["argument_bytes"] = memory["param_bytes"] + inputs + (
            cache_bytes if shape.kind == "decode" else 0)
        memory["output_bytes"] = logits + cache_bytes
        coll = step_collectives(params_abs, p_specs, mesh, None)
    coll_total = sum(coll.values())
    tokens = B * (shape.seq_len if shape.kind in ("train", "prefill")
                  else 1)
    mult = 6 if shape.kind == "train" else 2
    n_active = cfg.n_active_params()
    model_flops_global = mult * n_active * tokens
    flops = model_flops_global / split * share
    rl = roofline_terms(flops=flops, hbm_bytes=memory["argument_bytes"],
                        coll_bytes=coll_total, n_chips=n_chips,
                        peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
                        ici_bw=ICI_BW)
    out = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "axes": list(mesh.axis_names), "n_chips": n_chips,
        "kind": shape.kind, "optimizer": optimizer_name
        if shape.kind == "train" else None,
        "flops_per_chip": flops,
        "hbm_bytes_per_chip": memory["argument_bytes"],
        "collective_bytes_per_chip": coll_total, "collectives": coll,
        "memory": memory, "roofline": rl,
        "n_params": cfg.n_params(), "n_active_params": n_active,
        "model_flops_per_chip": model_flops_global / n_chips,
        "useful_flops_ratio": model_flops_global / n_chips / flops,
        "batch_split": split, "layout": layout, "skipped": False,
    }
    if shape.kind == "train":
        out["remat"] = remat
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    choices=sorted(SHAPE_REGISTRY))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="override mesh dims, e.g. '2,4' or '2,2,2'")
    ap.add_argument("--optimizer", default="adagrad",
                    choices=["adagrad", "adam", "sgd"])
    ap.add_argument("--no-remat", action="store_true",
                    help="a train step without the recompute")
    ignored = ap.add_argument_group(
        "ignored", "the reference's switches; they select nothing here")
    for flag in ("--no-donate", "--no-probe"):
        ignored.add_argument(flag, action="store_true")
    ap.add_argument("--layout", default="baseline",
                    help="comma list of layout features: fsdp_remap,"
                         "serve_fsdp,cache_seqshard (or 'baseline')")
    ap.add_argument("--json", default=None, help="append JSON line here")
    args = ap.parse_args(argv)

    res = run_dryrun(args.arch, args.shape, mesh=build_mesh(args),
                     optimizer_name=args.optimizer, layout=args.layout,
                     remat=not args.no_remat)
    line = json.dumps(res)
    print(line)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
