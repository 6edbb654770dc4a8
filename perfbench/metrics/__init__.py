"""Per-layer readers, one module per metric of ``BENCHMARK.json``'s
``per_layer``, named as the metric (``name.variant`` by ``name``'s). Each
has ``read(run)``: the metric's value from a trace run (``harness.Run``:
``trace``, a ``devtrace.TraceData``; ``spans``, the driver's own timings,
name -> ms per call; ``program_spans``, the program's spans over the
window, name -> ms per call; ``counters``, the program's counters over
the window; ``steps``, the window's step times in ms;
``peak_window_bytes``), or None where the run holds nothing to read."""
