"""Device ms a step in the model's forward pass and loss (the program's
``train.forward`` span in ``build_train_step``, timed by its CUDA events)."""


def read(run):
    calls = run.program_spans.get("train.forward")
    return sum(calls) / len(run.steps) if calls and run.steps else None
