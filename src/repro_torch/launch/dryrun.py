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
         step of ``distributed/sharded_step.py``, reckoned by
         ``step_collectives`` with the same ``wire_bytes`` its calls
         count; prefill and decode carry the gathers of the
         ``serve``-mode shards;
       - ``model_flops_per_chip``, ``n_params`` / ``n_active_params``:
         the reference's formulas (6 or 2 x active params x tokens, over
         the mesh's ranks); ``flops_per_chip``: the same work over the
         ranks the batch is split over, since the port's step replicates
         compute over ``model`` (ROADMAP A10c);
       - ``roofline``: ``roofline_terms`` with the H100 constants of
         ``launch/mesh.py``, the memory term from the argument bytes;
  4. emits one JSON line.

No counterpart, so left out: XLA's ``memory_analysis`` ``temp_bytes``
and generated code, ``raw_scan_counted`` and the cost probes, the HLO op
counts, and ``lower_s`` / ``compile_s`` / ``probe_s``. Nor do the
reference's ``remat``, ``donate`` and ``probe`` switches select anything
here: its ``--no-remat``, ``--no-donate`` and ``--no-probe`` flags parse,
in one group that is ignored, so its command lines run unchanged. Skips
are the reference's ``supports``.

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
from repro_torch.distributed.sharded_step import step_collectives
from repro_torch.distributed.sharding import (NamedSharding, P, batch_axis,
                                              batch_spec, cache_specs,
                                              local_shape, param_specs,
                                              parse_layout)
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


def run_dryrun(arch: Union[str, ArchConfig], shape: Union[str, InputShape], *,
               multi_pod: bool = False, mesh: Mesh = None,
               optimizer_name: str = "adagrad",
               layout: str = "baseline") -> Dict[str, Any]:
    """One (arch, shape, mesh)'s JSON record (module docstring). ``arch``
    is a registered name or an ``ArchConfig`` (a ``.reduced()`` one, say),
    ``shape`` a registered shape's name or an ``InputShape``;
    ``optimizer_name`` any of ``optim.get_optimizer``'s."""
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
    refused = None
    if shape.kind == "train":
        opt = get_optimizer(optimizer_name)
        state_abs = make_train_state(params_abs, opt)
        st_specs = param_specs(state_abs, cfg, mesh, "train", lay)
        memory["state_bytes"] = local_bytes(state_abs, st_specs, mesh)
        memory["argument_bytes"] = memory["state_bytes"] + _batch_bytes(
            specs["batch"], mesh, B, lay)
        memory["output_bytes"] = memory["state_bytes"] + METRICS_BYTES
        coll = step_collectives(params_abs, st_specs["params"], mesh, bentry)
        if cfg.moe is not None and split > 1:
            refused = (f"MoE under a batch split over {split} ranks "
                       f"(ROADMAP A10c)")
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
    flops = model_flops_global / split
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
    if refused:
        out["refused"] = refused
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
    ignored = ap.add_argument_group(
        "ignored", "the reference's switches; they select nothing here")
    for flag in ("--no-remat", "--no-donate", "--no-probe"):
        ignored.add_argument(flag, action="store_true")
    ap.add_argument("--layout", default="baseline",
                    help="comma list of layout features: fsdp_remap,"
                         "serve_fsdp,cache_seqshard (or 'baseline')")
    ap.add_argument("--json", default=None, help="append JSON line here")
    args = ap.parse_args(argv)

    res = run_dryrun(args.arch, args.shape, mesh=build_mesh(args),
                     optimizer_name=args.optimizer, layout=args.layout)
    line = json.dumps(res)
    print(line)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
