"""Device ms a step in the backward pass (the program's ``train.backward``
span in ``build_train_step``, timed by its CUDA events: ``autograd.grad``
with remat's recompute, and the zero-filled leaves it did not reach)."""


def read(run):
    calls = run.program_spans.get("train.backward")
    return sum(calls) / len(run.steps) if calls and run.steps else None
