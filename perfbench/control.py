"""The readings that the check's limits are set from, for one cell.

    python3 perfbench/control.py --workload <cell> --seeds 1-12 \\
        --control-seeds 13-15

For every seed it builds the cell's program from the seed, drives its
check steps, frees it, and runs the reference: the ``program`` readings
(the lower readings). On each control seed it also puts the reference
in the program's place twice: computed in TF32 (``control``, the
precision below the configuration's float32), and with half of each
step's batch left out, the mean taken over the rest (``half_batch``, a
fault). Each of the three is judged by the harness's own ``judge``
against the cell's limits (``*_correct``). One JSON line a seed, then
one line of the largest program reading and the smallest control and
fault reading of each number, and whether any run of each kind was
judged correct. The measured window is not run: these readings need
none.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("program", "control", "half_batch")


def seeds(spec: str):
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += range(int(a), int(b) + 1)
        elif part:
            out.append(int(part))
    return out


def readings(cell, seed: int, control: bool, device) -> dict:
    import importlib

    from perfbench.harness import judge
    from perfbench.reference.train import compare

    drv = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}").Driver(
            cell, seed, device, False)
    t = time.perf_counter()
    drv.setup()
    drv.release()
    prog, ref = drv.check()
    rec = {"seed": seed, "program": compare(prog, ref),
           "losses": prog.losses, "ref_losses": ref.losses}
    if control:
        rec["control"] = compare(drv.check("tf32")[1], ref)
        rec["half_batch"] = compare(drv.check("f32", drop_half=True)[1], ref)
    for kind in KINDS:
        if kind in rec:
            rec[f"{kind}_correct"] = judge(rec[kind], cell.limits)
    rec["seconds"] = time.perf_counter() - t
    return rec


def summary(recs) -> dict:
    out = {}
    for k in recs[0]["program"]:
        out[k] = {"lower": max(r["program"][k] for r in recs)}
        for kind in KINDS[1:]:
            got = [r[kind][k] for r in recs if kind in r]
            if got:
                out[k][kind] = min(got)
    for kind in KINDS:
        got = [r[f"{kind}_correct"] for r in recs if f"{kind}_correct" in r]
        if got:
            out[f"{kind}_correct"] = {"any": any(got), "all": all(got),
                                      "runs": len(got)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="13-15")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from perfbench.harness import load_cell

    cell = load_cell(ROOT, args.workload)
    ctl = set(seeds(args.control_seeds))
    recs = []
    for s in seeds(args.seeds) + sorted(ctl - set(seeds(args.seeds))):
        recs.append(readings(cell, s, s in ctl, args.device))
        print(json.dumps({"workload": cell.name, **recs[-1]}), flush=True)
    print(json.dumps({"workload": cell.name, "limits": cell.limits,
                      "summary": summary(recs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
