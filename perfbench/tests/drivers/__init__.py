"""One test module per driver of ``perfbench/drivers/``, named as it:
what the CPU tests need to run that driver's cells small and to plant
the faults its cells can have."""
