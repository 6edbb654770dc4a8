"""Carry weights between the JAX package and the port.

The port keeps the JAX parameter tree's names and layouts (einsum weights
``wq (d,H,hd)``, ``wo (H,hd,d)``, blocks stacked on a leading ``L`` axis),
so a transfer is a plain copy: both sides then compute the same function
on the same weights. The JAX side hands over its tree as numpy arrays
(``jax.tree.map(np.asarray, params)``); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.mlitb_cnn import CNN_EXTRAS
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models.layers import ParamTree
from repro_torch.models.transformer import abstract_params


def _to_tensor(a: Any, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: numpy-foreign
        a = a.astype(np.float32)
    return torch.tensor(a).to(dtype)


def params_from_jax(tree: Mapping[str, Any], cfg: ArchConfig,
                    device: DeviceLike = "cuda") -> ParamTree:
    """The port's parameters from the tree that
    ``repro.models.transformer.init_params`` returns, as numpy arrays:
    every family's nesting (stacked experts, a hybrid's ``super`` /
    ``tail``), each leaf in the dtype the port's ``init_params`` gives it
    (the float32 router and SSM leaves stay float32 in a bf16 model).
    Keys and shapes must match ``abstract_params(cfg)``; raises
    otherwise."""
    dev = resolve_device(device)

    def walk(t, spec, path):
        if set(t) != set(spec):
            raise ValueError(f"params_from_jax: keys at {path or '/'} are "
                             f"{sorted(t)}, expected {sorted(spec)}")
        out = {}
        for k in sorted(spec):
            if isinstance(spec[k], dict):
                out[k] = walk(t[k], spec[k], f"{path}/{k}")
                continue
            x = _to_tensor(t[k], spec[k].dtype)
            if x.shape != spec[k].shape:
                raise ValueError(f"params_from_jax: {path}/{k} has shape "
                                 f"{tuple(x.shape)}, expected "
                                 f"{tuple(spec[k].shape)}")
            out[k] = x
        return out

    return ParamTree(walk(tree, abstract_params(cfg), "")).to(dev)


def params_to_numpy(params: ParamTree) -> dict:
    """The inverse: a nested dict of numpy arrays with the JAX tree's
    names (bfloat16 leaves come out as float32)."""
    def leaf(v: torch.Tensor) -> np.ndarray:
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()

    def walk(t):
        return {k: walk(v) if isinstance(v, ParamTree) else leaf(v)
                for k, v in t.items()}
    return walk(params)


def cnn_params_from_jax(tree: Mapping[str, Any], device: DeviceLike = "cuda"
                        ) -> Dict[str, torch.Tensor]:
    """The port's conv-net parameters from the tree that
    ``repro.models.cnn.init_params`` returns, as numpy arrays: a plain
    copy that keeps the JAX layouts (``conv_w`` HWIO, ``fc_w`` indexed by
    NHWC-flattened features). Raises on missing keys or other shapes."""
    dev = resolve_device(device)
    ex = CNN_EXTRAS
    feat = ex.conv_filters * (ex.image_hw // ex.pool) ** 2
    shapes = {"conv_w": (ex.kernel, ex.kernel, ex.channels,
                         ex.conv_filters),
              "conv_b": (ex.conv_filters,),
              "fc_w": (feat, ex.n_classes), "fc_b": (ex.n_classes,)}
    if set(tree) != set(shapes):
        raise ValueError(f"cnn_params_from_jax: keys {sorted(tree)}, "
                         f"expected {sorted(shapes)}")
    out = {}
    for k in sorted(shapes):
        x = _to_tensor(tree[k], torch.float32)
        if tuple(x.shape) != shapes[k]:
            raise ValueError(f"cnn_params_from_jax: {k} has shape "
                             f"{tuple(x.shape)}, expected {shapes[k]}")
        out[k] = x.to(dev)
    return out


def cnn_params_to_numpy(params: Mapping[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    """The inverse: the conv net's parameters as numpy arrays with the
    JAX tree's names and layouts."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
