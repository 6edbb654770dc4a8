"""Checkpoint store (port of ``repro.checkpoint.io``): research-closure
JSON + the npz fast path, and the full-training-state ``TrainState``
snapshot for churn-safe resume.

The file layouts are the JAX package's, so either package reads what the
other wrote: an npz of named arrays with a JSON header (params), and an
npz whose ``__train_state__`` entry is the JSON skeleton of the loop's
``state_dict()`` with every array replaced by an ``{"__array__": key}``
placeholder. Tensors are copied to host numpy before they are written;
nothing is pickled (``np.load`` runs with ``allow_pickle=False``), and a
corrupt or truncated file raises ``ValueError``.

TrainState is everything a crash would lose beyond bare params:
optimizer state, per-worker error-feedback residuals, scheduler EWMAs,
the adaptive keep controller's state, the allocator's assignment, the
worker registry, pending membership events, the iteration history,
step/clock counters and (optionally) the simulated cluster's RNG streams.
The resume contract: rebuild the same components from config,
``restore`` the snapshot, and the continued run is bit-exact with the
uninterrupted one.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.closure import ResearchClosure, config_to_json
from repro_torch.core.flatbuf import build_tree, flat_spec, tree_paths

PyTree = Any

TRAIN_STATE_VERSION = 1


def _host(x: Any) -> np.ndarray:
    """A leaf as a host numpy array (never an object array: that would
    need pickling)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 tensors have no numpy dtype; cast "
                            "them before checkpointing")
        x = x.numpy()
    arr = np.asarray(x)
    if arr.dtype == object:
        raise TypeError(f"cannot checkpoint an object array ({type(x)})")
    return arr


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {"/".join(path): _host(x) for path, x in tree_paths(tree)}


def _unflatten(flat: Dict[str, np.ndarray]) -> PyTree:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _atomic_savez(path: str, **arrays: Any) -> None:
    """Crash-safe ``np.savez``: write to a temp file in the SAME
    directory, fsync, then ``os.replace`` onto ``path``, so a crash
    mid-write leaves the previous checkpoint intact. ``np.savez`` appends
    ``.npz`` to bare names; the path is normalized first."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _load_npz(path: str, key: str, what: str
              ) -> Tuple[Any, Dict[str, np.ndarray]]:
    """(JSON entry ``key``, the other arrays) of an npz; a corrupt or
    truncated file raises ValueError (a missing one FileNotFoundError)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(str(z[key]))
            arrays = {k: z[k] for k in z.files if k != key}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, KeyError, EOFError, OSError,
            ValueError) as e:
        raise ValueError(f"corrupt or truncated {what} {path!r}: {e}") from e
    return header, arrays


def save_npz(path: str, params: PyTree, *, cfg: Optional[ArchConfig] = None,
             meta: Optional[Dict[str, Any]] = None) -> None:
    flat = _flatten(params)
    header = {"meta": meta or {}}
    if cfg is not None:
        header["config"] = config_to_json(cfg)
    _atomic_savez(path, __header__=json.dumps(header), **flat)


def load_npz(path: str) -> Tuple[PyTree, Dict[str, Any]]:
    """(numpy param tree, header) of a ``save_npz`` file."""
    header, flat = _load_npz(path, "__header__", "checkpoint")
    return _unflatten(flat), header


# ---------------------------------------------------------------------------
# TrainState: full-state snapshot for churn-safe, bit-exact resume
# ---------------------------------------------------------------------------
def _pack(obj: Any, path: str, arrays: Dict[str, np.ndarray]) -> Any:
    """Split a state_dict into a JSON-safe skeleton + named arrays.
    Arrays (numpy, or torch tensors copied to host numpy) are replaced by
    ``{"__array__": key}`` placeholders and stored losslessly in the npz;
    python floats ride JSON's repr round-trip, which is exact."""
    # numpy scalars become python scalars BEFORE the array checks, or
    # they would round-trip as 0-d arrays
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, (np.ndarray, torch.Tensor)) or (
            hasattr(obj, "__array__")
            and not isinstance(obj, (int, float, bool, str))):
        arrays[path] = _host(obj)
        return {"__array__": path}
    if isinstance(obj, dict):
        return {str(k): _pack(v, f"{path}/{k}", arrays)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pack(v, f"{path}/{i}", arrays)
                for i, v in enumerate(obj)]
    return obj


def _unpack(obj: Any, arrays: Dict[str, np.ndarray]) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {"__array__"}:
            return arrays[obj["__array__"]]
        return {k: _unpack(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, arrays) for v in obj]
    return obj


@dataclass
class TrainState:
    """A serializable snapshot of one master event loop (and optionally
    its simulated cluster) at an iteration boundary."""
    loop: Dict[str, Any]
    cluster: Optional[Dict[str, Any]] = None
    version: int = TRAIN_STATE_VERSION

    @classmethod
    def capture(cls, loop, cluster=None) -> "TrainState":
        """Snapshot ``loop.state_dict()`` (+ the cluster's RNG streams
        when given — required for bit-exact simulated resume)."""
        return cls(loop=loop.state_dict(),
                   cluster=None if cluster is None
                   else cluster.state_dict())

    def restore(self, loop, cluster=None) -> None:
        """Load this snapshot into freshly constructed components (same
        config as the original run)."""
        if (cluster is None) != (self.cluster is None):
            # a silent skip would hand back fresh RNG streams and break
            # the bit-exact resume contract
            raise ValueError(
                "cluster mismatch: snapshot "
                f"{'has' if self.cluster is not None else 'lacks'} cluster "
                f"state but restore() was "
                f"{'not ' if cluster is None else ''}given a cluster")
        loop.load_state_dict(self.loop)
        if cluster is not None:
            cluster.load_state_dict(self.cluster)


def save_train_state(path: str, state: TrainState) -> None:
    arrays: Dict[str, np.ndarray] = {}
    skeleton = _pack({"version": state.version, "loop": state.loop,
                      "cluster": state.cluster}, "s", arrays)
    _atomic_savez(path, __train_state__=json.dumps(skeleton), **arrays)


def load_train_state(path: str) -> TrainState:
    skeleton, arrays = _load_npz(path, "__train_state__", "TrainState")
    obj = _unpack(skeleton, arrays)
    if int(obj["version"]) != TRAIN_STATE_VERSION:
        raise ValueError(f"unsupported TrainState version {obj['version']}")
    return TrainState(loop=obj["loop"], cluster=obj["cluster"],
                      version=int(obj["version"]))


def serving_params_from_train_state(state: Any, template: PyTree
                                    ) -> Tuple[PyTree, int]:
    """The master's params from a TrainState snapshot, so a serving
    engine can be seeded directly from a training checkpoint: returns
    ``(params, step)``, where ``step`` doubles as the engine's starting
    version (the live publish path's numbering).

    ``state`` is a ``TrainState`` or a path to one; ``template`` is a
    param tree of the run's architecture on the target device (an
    ``init_params`` output will do): its layout unflattens the reducer's
    flat fp32 buffer into model shapes and dtypes, and its device is
    where the params land.

    For a two-tier ``HierarchicalMaster`` snapshot the served model is the
    CONSENSUS — the mean of the live regions' flat buffers, summed in
    sorted order — and the version is the deepest region's step."""
    if isinstance(state, str):
        state = load_train_state(state)
    pairs = list(tree_paths(template))
    dev = pairs[0][1].device
    if "regions" in state.loop and "reducer" not in state.loop:
        live = sorted(str(r) for r in state.loop["active"])
        flats = [np.asarray(state.loop["regions"][r]["reducer"]["flat"],
                            np.float32) for r in live]
        consensus = np.mean(np.stack(flats, 0), axis=0)
        params = flat_spec(template).unflatten(
            torch.as_tensor(consensus).to(dev))
        step = max(int(state.loop["regions"][r]["step"]) for r in live)
        return params, step
    red = state.loop["reducer"]
    if red["fused"]:
        flat = torch.as_tensor(np.asarray(red["flat"], np.float32)).to(dev)
        params = flat_spec(template).unflatten(flat)
    else:
        stored = red["param_leaves"]
        if len(stored) != len(pairs):
            raise ValueError(
                f"snapshot has {len(stored)} param leaves, template has "
                f"{len(pairs)} — wrong architecture?")
        params = build_tree(tuple(p for p, _ in pairs),
                            [torch.as_tensor(np.asarray(a)).to(dev)
                             for a in stored])
    return params, int(state.loop["step"])


def save_closure(path: str, closure: ResearchClosure,
                 npz_sidecar: bool = True) -> None:
    closure.save(path)
    if npz_sidecar:
        save_npz(path + ".npz", closure.params, cfg=closure.config,
                 meta={"arch": closure.arch, "step": closure.step})


def load_closure(path: str) -> ResearchClosure:
    return ResearchClosure.load(path)
