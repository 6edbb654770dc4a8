from repro_torch.optim.adagrad import adagrad  # noqa: F401
from repro_torch.optim.adam import adam  # noqa: F401
from repro_torch.optim.base import Optimizer  # noqa: F401
from repro_torch.optim.sgd import sgd  # noqa: F401


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adagrad": adagrad, "adam": adam, "sgd": sgd}[name](**kw)
