"""Research closures — MLitB §2.3 / §6.4 (port of ``repro.core.closure``).

"a single object containing model and algorithm configuration plus code,
along with model parameters that can be executed (and therefore tested and
analyzed) by other researchers."

A closure is one JSON document holding a format tag and schema version,
the model (arch id + every ``ArchConfig`` field), the algorithm settings,
the parameter tree (``"listing"``: nested lists; ``"b64"``: base64 of the
raw little-endian bytes per leaf with shape and dtype), the training
metrics and the lineage. The document is byte-for-byte the JAX package's:
a closure written by either package loads in the other. Leaves are numpy
arrays; a tree of torch tensors is copied to host numpy on encode, and
``torchify`` puts a decoded tree on a device.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
from repro_torch.core.flatbuf import tree_map
from repro_torch.kernels.runtime import DeviceLike, resolve_device

FORMAT = "mlitb.research-closure"
VERSION = 2

PyTree = Any


# ---------------------------------------------------------------------------
# Param tree <-> JSON
# ---------------------------------------------------------------------------
def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("closure leaves must be numpy-representable; "
                            "cast bfloat16 tensors first")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _encode_leaf(x, encoding: str) -> Dict[str, Any]:
    arr = _host(x)
    if encoding == "listing":
        return {"shape": list(arr.shape), "dtype": str(arr.dtype),
                "data": arr.tolist()}
    raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "b64": base64.b64encode(raw).decode("ascii")}


def _decode_leaf(d: Dict[str, Any]) -> np.ndarray:
    dtype = np.dtype(d["dtype"])
    if "data" in d:
        return np.asarray(d["data"], dtype=dtype).reshape(d["shape"])
    raw = base64.b64decode(d["b64"])
    return np.frombuffer(raw, dtype=dtype.newbyteorder("<")).astype(
        dtype).reshape(d["shape"])


def encode_tree(tree: PyTree, encoding: str = "b64") -> Any:
    return tree_map(lambda x: _encode_leaf(x, encoding), tree)


def decode_tree(obj: Any) -> PyTree:
    if isinstance(obj, dict) and ("b64" in obj or "data" in obj):
        return _decode_leaf(obj)
    return {k: decode_tree(v) for k, v in obj.items()}


# ---------------------------------------------------------------------------
# Config <-> JSON
# ---------------------------------------------------------------------------
def config_to_json(cfg: ArchConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def config_from_json(d: Dict[str, Any]) -> ArchConfig:
    d = dict(d)
    if d.get("moe"):
        d["moe"] = MoEConfig(**d["moe"])
    if d.get("ssm"):
        d["ssm"] = SSMConfig(**d["ssm"])
    return ArchConfig(**d)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ResearchClosure:
    arch: str
    config: ArchConfig
    algorithm: Dict[str, Any]
    params: PyTree
    metrics: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    step: int = 0
    parent: Optional[str] = None

    # ------------------------------------------------------------------
    def to_json(self, encoding: str = "b64") -> str:
        body = {
            "format": FORMAT,
            "version": VERSION,
            "model": {"arch": self.arch, "config": config_to_json(self.config)},
            "algorithm": self.algorithm,
            "params": encode_tree(self.params, encoding),
            "metrics": self.metrics,
            "step": self.step,
            "parent": self.parent,
        }
        return json.dumps(body, sort_keys=True)

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    @classmethod
    def from_json(cls, s: str) -> "ResearchClosure":
        body = json.loads(s)
        if body.get("format") != FORMAT:
            raise ValueError(f"not a research closure: {body.get('format')}")
        if body.get("version", 1) > VERSION:
            raise ValueError("closure from a newer schema version")
        return cls(
            arch=body["model"]["arch"],
            config=config_from_json(body["model"]["config"]),
            algorithm=body["algorithm"],
            params=decode_tree(body["params"]),
            metrics=body.get("metrics", []),
            step=body.get("step", 0),
            parent=body.get("parent"),
        )

    # ------------------------------------------------------------------
    def save(self, path: str, encoding: str = "b64") -> None:
        with open(path, "w") as f:
            f.write(self.to_json(encoding))

    @classmethod
    def load(cls, path: str) -> "ResearchClosure":
        with open(path) as f:
            return cls.from_json(f.read())

    def child(self, params: PyTree, step: int,
              metrics: Optional[List[Dict[str, Any]]] = None
              ) -> "ResearchClosure":
        """Continuation closure (resume lineage, §6.4)."""
        return ResearchClosure(
            arch=self.arch, config=self.config, algorithm=self.algorithm,
            params=params, metrics=metrics or self.metrics, step=step,
            parent=self.digest)


def torchify(tree: PyTree, device: DeviceLike = "cuda") -> PyTree:
    """A decoded (numpy) tree as a nested dict of tensors on ``device``
    (the counterpart of ``repro.core.closure.jaxify``)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(dev), tree)
