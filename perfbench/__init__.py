"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: one cell (a model configuration under a traffic mix) a run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration (``configs/``), its traffic mix (``workloads/``, which also
names the driver in ``drivers/``), its correctness limits (``limits/``),
and one reader per metric (``endtoend/``, ``metrics/``). The plain
reference that decides ``correct`` lives in ``reference/`` and imports
nothing of the program; each model family is a module of
``reference/families/``, found by the configuration's ``arch_type``.
"""
