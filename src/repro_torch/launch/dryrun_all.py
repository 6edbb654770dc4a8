"""Grid runner for the multi-pod dry-run (the counterpart of
``repro.launch.dryrun_all``).

Pair mode:
    python -m repro_torch.launch.dryrun_all --arch qwen3-4b \\
        --shape train_4k --out results.jsonl
  runs BOTH meshes, single-pod (16, 16) and multi-pod (2, 16, 16),
  appending two JSON lines (``mesh_tag`` 1pod-256 / 2pod-512).

Grid mode:
    python -m repro_torch.launch.dryrun_all --all --out results.jsonl
  every (arch, shape) of the assignment, resuming past (arch, shape,
  mesh) entries already in the output file; an unsupported pair writes
  one skip line, as the reference's. The reference runs each pair in a
  subprocess because XLA locks the host device count at first use; the
  port allocates nothing and holds no devices, so the grid runs in this
  one process.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.all_configs import ASSIGNED_ARCHS
from repro_torch.configs.shapes import SHAPE_REGISTRY
from repro_torch.launch.dryrun import run_dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import supports

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = (("1pod-256", (16, 16), ("data", "model")),
          ("2pod-512", (2, 16, 16), ("pod", "data", "model")))


def pair_main(arch: str, shape: str, out: str):
    results = []
    for tag, dims, axes in MESHES:
        r = run_dryrun(arch, shape, mesh=Mesh(dims, axes))
        r["mesh_tag"] = tag
        results.append(r)
        if r.get("skipped"):
            break
    with open(out, "a") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    return results


def existing_keys(out: str):
    keys = set()
    if os.path.exists(out):
        with open(out) as f:
            for line in f:
                try:
                    d = json.loads(line)
                    keys.add((d["arch"], d["shape"], d.get("mesh_tag", "")))
                except (ValueError, KeyError):
                    pass
    return keys


def grid_main(out: str):
    done = existing_keys(out)
    todo = []
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            ok, reason = supports(get_config(arch), get_shape(shape))
            if not ok:
                if (arch, shape, "1pod-256") not in done:
                    with open(out, "a") as f:
                        f.write(json.dumps(
                            {"arch": arch, "shape": shape, "skipped": True,
                             "reason": reason, "mesh_tag": "1pod-256"})
                            + "\n")
                continue
            if all((arch, shape, tag) in done for tag, _, _ in MESHES):
                continue
            todo.append((arch, shape))
    print(f"grid: {len(todo)} pairs to run", flush=True)
    for i, (arch, shape) in enumerate(todo):
        t0 = time.time()
        pair_main(arch, shape, out)
        print(f"[{i+1}/{len(todo)}] {arch} {shape}: ok "
              f"({time.time()-t0:.1f}s)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=sorted(SHAPE_REGISTRY))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.all:
        grid_main(args.out)
    elif args.arch and args.shape:
        pair_main(args.arch, args.shape, args.out)
    else:
        ap.error("give --all, or --arch and --shape")
    return 0


if __name__ == "__main__":
    sys.exit(main())
