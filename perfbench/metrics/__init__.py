"""Per-layer readers, one module per metric of ``BENCHMARK.json``'s
``per_layer``, named as the metric (``name.variant`` by ``name``'s). Each has ``read(run)``: the metric's
value from a trace run (``harness.Run``: ``trace``, a ``devtrace.TraceData``;
``spans``, name -> ms per call; ``steps``, the window's step times in ms;
``peak_window_bytes``), or None where the run holds nothing to read."""
