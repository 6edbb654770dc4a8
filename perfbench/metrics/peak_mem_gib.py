"""The device memory the window's steps held at most
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(run):
    b = run.peak_window_bytes
    return b / 2 ** 30 if b else None
