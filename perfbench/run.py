"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. It needs a CUDA card (it exits with
3 otherwise) and the program under ``src/`` beside it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench_cache"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    # the script's own directory would shadow the standard library
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    return harness.main(args, ROOT, T0)


if __name__ == "__main__":
    sys.exit(main())
