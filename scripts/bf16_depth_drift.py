#!/usr/bin/env python3
"""How far each package's cached decode parts from its own cacheless
forward at full depth, in bfloat16 and in float32, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/bf16_depth_drift.py

For ``mamba2-780m`` (48 layers), ``zamba2-7b`` (81 layers: 13 supers of
5 SSM + 1 attention block, 3 tail layers), ``paligemma-3b`` (18 layers)
and ``whisper-large-v3`` (32 + 32 layers), each at its full depth with
the width of ``.reduced()`` (d 128, 4 heads of 32, vocab 512, the small
SSM, 4 patch tokens, 16 frames), one set of weights drawn by the JAX
package goes into both packages (``params_from_jax``). Each package then
serves ``launch.serve``'s single-shot batch (4 x 24 prompts from seed 1,
with the patch / frame embeddings, 12 greedy tokens) through its own
``prefill`` + ``decode_step``, and runs its own ``forward`` over the
growing sequence of its own tokens; the script prints, per package, the
largest |cached - forward| logit difference at the prefill and at each
decoded step, beside the logits' standard deviation. Run in both dtypes,
it shows whether the port's bf16 drift at depth is the reference's.
Needs JAX and PyTorch; nothing runs on a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as j_tf
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.serve import ONESHOT_GEN, oneshot_inputs
from repro_torch.models import transformer as t_tf

ARCHS = ("mamba2-780m", "zamba2-7b", "paligemma-3b", "whisper-large-v3")


def deep_narrow(name: str, dtype: str, get=get_config):
    """``name`` at its full depth with ``.reduced()``'s widths."""
    full = get(name)
    return dataclasses.replace(
        full.reduced(), n_layers=full.n_layers,
        hybrid_attn_period=full.hybrid_attn_period,
        n_encoder_layers=full.n_encoder_layers, param_dtype=dtype,
        activ_dtype=dtype)


def jax_run(cfg, params, prompts, kw):
    """(cached logits (B, G, V), forward logits (B, G, V)) of the JAX
    package, float32 numpy."""
    kw = {k: jnp.asarray(v) for k, v in kw.items()}
    P = prompts.shape[1]
    off = cfg.n_prefix_tokens if cfg.arch_type == "vlm" else 0
    logits, cache = jax.jit(lambda p, t, k: j_tf.prefill(p, cfg, t, **k))(
        params, jnp.asarray(prompts), kw)
    decode = jax.jit(lambda p, t, pos, c: j_tf.decode_step(p, cfg, t, pos,
                                                           c))
    fwd = jax.jit(lambda p, t, k: j_tf.forward(p, cfg, t, remat=False,
                                               **k)[0][:, -1])
    cached, toks = [logits[:, -1]], []
    for t in range(ONESHOT_GEN):
        toks.append(jnp.argmax(cached[-1], -1)[:, None].astype(jnp.int32))
        if t == ONESHOT_GEN - 1:
            break
        logits, cache = decode(params, toks[-1],
                               jnp.asarray(P + off + t, jnp.int32), cache)
        cached.append(logits[:, -1])
    seq = jnp.concatenate([jnp.asarray(prompts)] + toks, axis=1)
    grown = [fwd(params, seq[:, :P + t], kw) for t in range(ONESHOT_GEN)]
    as_np = (lambda xs: np.stack([np.asarray(x, np.float32) for x in xs],
                                 axis=1))
    return as_np(cached), as_np(grown)


def port_run(cfg, params, prompts, kw):
    """The same for the port, on the CPU."""
    kw = {k: torch.tensor(v) for k, v in kw.items()}
    P = prompts.shape[1]
    off = cfg.n_prefix_tokens if cfg.arch_type == "vlm" else 0
    with torch.inference_mode():
        logits, cache = t_tf.prefill(params, cfg, torch.tensor(prompts),
                                     **kw)
        cached, toks = [logits[:, -1]], []
        for t in range(ONESHOT_GEN):
            toks.append(cached[-1].argmax(-1)[:, None].to(torch.int32))
            if t == ONESHOT_GEN - 1:
                break
            logits, cache = t_tf.decode_step(params, cfg, toks[-1],
                                             P + off + t, cache)
            cached.append(logits[:, -1])
        seq = torch.cat([torch.tensor(prompts)] + toks, dim=1)
        grown = [t_tf.forward(params, cfg, seq[:, :P + t], remat=False,
                              **kw)[0][:, -1] for t in range(ONESHOT_GEN)]
    return (torch.stack(cached, 1).float().numpy(),
            torch.stack(grown, 1).float().numpy())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+", default=list(ARCHS),
                    choices=ARCHS)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"],
                    choices=["bfloat16", "float32"])
    args = ap.parse_args()
    torch.manual_seed(0)
    for name in args.archs:
        for dtype in args.dtypes:
            t0 = time.perf_counter()
            jcfg = deep_narrow(name, dtype, j_get_config)
            tcfg = deep_narrow(name, dtype)
            jp = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
            tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
            prompts, kw = oneshot_inputs(tcfg, 0)
            rows = {"repro": jax_run(jcfg, jp, prompts, kw),
                    "repro_torch": port_run(tcfg, tp, prompts, kw)}
            depth = f"{tcfg.n_encoder_layers} + {tcfg.n_layers}" \
                if tcfg.enc_dec else f"{tcfg.n_layers}"
            for pkg, (cached, grown) in rows.items():
                drift = np.abs(cached - grown).max(axis=(0, 2))
                print(f"[drift] {name} ({depth} layers, d {tcfg.d_model}) "
                      f"{dtype} {pkg:<11}: |cached - forward| prefill "
                      f"{drift[0]:.3g}, decode max {drift[1:].max():.3g} "
                      f"(steps: {' '.join(f'{d:.3g}' for d in drift[1:])}); "
                      f"logit std {grown.std():.3g}")
            print(f"[drift] {name} {dtype}: {time.perf_counter() - t0:.1f} s "
                  f"on the CPU")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
