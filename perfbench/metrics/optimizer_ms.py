"""Device ms a step in the optimizer's update (AdaGrad over every leaf),
from CUDA events around the ``update`` the train step calls."""


def read(run):
    calls = run.spans.get("optimizer")
    return sum(calls) / len(calls) if calls else None
