"""Device ms an iteration in the reducer (``MasterReducer.reduce_and_step``:
the top-k channel with error feedback, the segment-sum, AdaGrad), from
CUDA events around each call."""


def read(run):
    calls = run.spans.get("fleet.reduce")
    if not calls or not run.steps:
        return None
    return sum(calls) / len(run.steps)
