"""Seconds from the process's start to the first timed step: imports,
the CUDA context, weights and data from the seed, the program's set-up
and its first steps (which warm every shape the window uses)."""


def read(w):
    return w.setup_s
