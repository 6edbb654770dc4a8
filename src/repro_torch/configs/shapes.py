"""Assigned input shapes (a copy of ``repro.configs.shapes``).

Each shape names a workload kind:
  - train:   full fwd+bwd+optimizer step over (batch, seq)
  - prefill: forward pass producing KV cache + last-token logits
  - decode:  ONE new token against a KV cache (or SSM state) of kv_len
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    sliding_window: int = 0        # forced SWA window for attention archs (decode-long)


SHAPE_REGISTRY: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode", sliding_window=8_192),
}


def get_shape(name: str) -> InputShape:
    return SHAPE_REGISTRY[name]
