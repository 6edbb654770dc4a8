"""The elastic training stack over a dense LM (port of the flat branch of
``repro.launch.train_serve``).

``build_training`` assembles the paper's event loop around ``cfg``'s LM:
a seeded heterogeneous fleet (``_fleet_profiles``) on the discrete-event
simulator, every worker computing real next-token gradients on the
problem's device, the fused top-k compressed reduce with AdaGrad, and
deadline partial participation. ``launch/train.py --simulate`` and
``chip_smoke.py`` drive it.

Not ported yet: the two-tier hierarchy (``TrainingConfig(hierarchy=)``,
ROADMAP A5) and the live train->serve loop (``run_train_serve`` and this
module's CLI, ROADMAP A7).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

from repro_torch.kernels.runtime import DeviceLike

_UNSET: Any = object()

# tiny default LM: big enough to have real train/serve dynamics, small
# enough that the CPU tests run the whole loop in seconds
TINY_SERVE_LM = dict(
    name="train-serve-tiny", arch_type="dense", n_layers=2, d_model=32,
    n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=128, head_dim=16,
    param_dtype="float32", activ_dtype="float32", tie_embeddings=True)


def tiny_cfg():
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**TINY_SERVE_LM)


def _fleet_profiles(churny: bool):
    from repro_torch.core.simulation import DeviceProfile
    profiles = [DeviceProfile("ws0", 300.0, 0.010, 0.20),
                DeviceProfile("ws1", 300.0, 0.012, 0.20),
                DeviceProfile("lap", 150.0, 0.030, 0.40)]
    if churny:
        profiles.append(DeviceProfile("strag", 200.0, 0.050, 0.40,
                                      straggle_p=0.3, straggle_factor=8.0))
    return profiles


def build_training(cfg, *, training=None, seed: int = 0,
                   n_data: int = 512, seq_len: int = 16,
                   lr: float = 0.1, frac: float = 0.1,
                   churny: bool = True,
                   fault_profiles: Optional[Dict[str, Any]] = None,
                   optimizer=None, device: DeviceLike = "cuda",
                   init_params=None,
                   T: Any = _UNSET, publish_every: Any = _UNSET,
                   publish_fn: Any = _UNSET, guardrails: Any = _UNSET):
    """An elastic training stack over ``cfg``'s LM on ``device``: fused
    top-k compressed reduce, deadline partial participation, and (when
    ``churny``) a heterogeneous fleet with a probabilistic straggler.
    Returns ``(MasterEventLoop, cluster, params)``.

    ``training=TrainingConfig(...)`` is the construction surface; the
    historical flat kwargs (T/publish_every/publish_fn/guardrails) still
    work for one deprecation cycle, and mixing both forms raises. With no
    explicit deadline the fleet gets the churny default (quantile 0.5
    when ``churny``, stall-on-slowest otherwise). ``init_params`` (a
    parameter tree on ``device``) replaces the seeded initialisation;
    ``optimizer`` replaces AdaGrad(lr) (plain SGD lets a garbage
    gradient actually diverge the params)."""
    from repro_torch.core import (AdaptiveScheduler, GradientCompressor,
                                  JoinEvent, MasterEventLoop, MasterReducer,
                                  TrainingConfig, UploadDataEvent)
    from repro_torch.core.simulation import SimulatedCluster, make_lm_problem
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adagrad

    dev = resolve_device(device)
    flat = {k: v for k, v in [
        ("T", T), ("publish_every", publish_every),
        ("publish_fn", publish_fn), ("guardrails", guardrails),
    ] if v is not _UNSET}
    if training is not None and flat:
        raise ValueError(
            "pass training=TrainingConfig(...) OR the flat kwargs, "
            f"not both (got flat {sorted(flat)})")
    if training is None:
        if flat:
            warnings.warn(
                f"build_training flat kwargs ({sorted(flat)}) are "
                "deprecated; pass training=TrainingConfig(...)",
                DeprecationWarning, stacklevel=2)
        flat.setdefault("T", 0.5)
        training = TrainingConfig.from_flat(
            deadline_quantile=0.5 if churny else None, **flat)

    (X, y), grad_fn = make_lm_problem(cfg, n_data=n_data, seq_len=seq_len,
                                      seed=seed, device=dev)
    params = (tf.init_params(cfg, seed=seed, device=dev)
              if init_params is None else init_params)
    reducer = MasterReducer(params, optimizer or adagrad(lr=lr),
                            compressor=GradientCompressor("topk", frac=frac),
                            fused=True)
    cluster = SimulatedCluster(grad_fn=grad_fn, data=(X, y), mode="real",
                               seed=seed, device=dev)
    loop = MasterEventLoop(
        reducer=reducer, cluster=cluster,
        scheduler=AdaptiveScheduler(T=training.T, prior_power=300.0,
                                    min_budget=0.05),
        training=training)
    loop.submit(UploadDataEvent(range(n_data)))
    for i, prof in enumerate(_fleet_profiles(churny)):
        cluster.add_worker(f"w{i}", prof)
        loop.submit(JoinEvent(f"w{i}", capacity=n_data))
    for w, fp in (fault_profiles or {}).items():
        cluster.set_faults(w, fp)
    return loop, cluster, params


def run_train_serve(*args, **kwargs):
    """The live train->serve loop: not ported yet."""
    raise NotImplementedError(
        "run_train_serve, the live train->serve loop, is not ported yet "
        "(ROADMAP A7)")
