"""End-to-end readers, one module per metric of ``BENCHMARK.json``'s
``end_to_end``, named as the metric (``name.variant`` by ``name``'s).
Each has ``read(window)``: the
value from the measured window (``harness.Window``: ``tokens``,
``seconds``, ``flops``, ``peak_flops``, ``setup_s``), or None."""
