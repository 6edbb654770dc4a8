"""Abstract input specifications for every (architecture x input-shape)
workload — the dry-run's batch source (the counterpart of
``repro.launch.specs``). The reference's ``ShapeDtypeStruct`` stand-ins
are tensors on the ``meta`` device: a shape and a dtype, nothing
allocated.

``effective_config`` applies shape-driven variants: ``long_500k`` forces
the sliding-window attention variant (window 8192) on attention-bearing
archs so decode state is O(window); SSM archs are untouched.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import transformer as tf
from repro_torch.models.layers import dtype_of

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in."""
    return torch.empty(shape, dtype=dtype, device=META)


def effective_config(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    if shape.sliding_window and not cfg.attention_free:
        return cfg.with_sliding_window(shape.sliding_window)
    return cfg


def supports(cfg: ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    """(supported, reason-if-not) for the assignment's documented skips."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return False, ("enc-dec audio backbone has no 500k-token decode "
                       "analogue (fixed 1500-frame encoder)")
    return True, ""


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """Trees of meta tensors keyed by step argument.

    train  : {"batch": {tokens, labels, mask[, prefix|frames]}}
    prefill: {"batch": {tokens[, prefix|frames]}}
    decode : {"token", "pos", "cache"}
    """
    return input_specs_eff(effective_config(cfg, shape), shape)


def input_specs_eff(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """As ``input_specs`` but for an ALREADY-effective config."""
    B, S = shape.global_batch, shape.seq_len
    adt = dtype_of(cfg.activ_dtype)

    def tok(s):
        return sds(s, torch.int32)

    def with_frontend(batch):
        if cfg.arch_type == "vlm":
            batch["prefix"] = sds((B, cfg.n_prefix_tokens, cfg.d_model), adt)
        if cfg.arch_type == "audio":
            batch["frames"] = sds((B, cfg.encoder_seq, cfg.d_model), adt)
        return {"batch": batch}

    if shape.kind == "train":
        return with_frontend({"tokens": tok((B, S)), "labels": tok((B, S)),
                              "mask": sds((B, S), torch.float32)})
    if shape.kind == "prefill":
        return with_frontend({"tokens": tok((B, S))})
    if shape.kind == "decode":
        cache = tf.init_decode_cache(cfg, B, S, device=META)
        return {"token": tok((B, 1)), "pos": sds((), torch.int32),
                "cache": cache}
    raise ValueError(shape.kind)
