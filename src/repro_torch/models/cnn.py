"""The paper's use-case model: a small convolutional NN (MLitB §3.5); port
of ``repro.models.cnn``.

"a 28x28 input layer connected to 16 convolution filters (with pooling),
followed by a fully connected output layer" — the network the elastic-SGD
demo trains with distributed SGD + AdaGrad.

Parameters keep the JAX package's names and layouts, so a weight transfer
is a plain copy and flat-buffer indices agree across the two packages:
``conv_w`` HWIO ``(5, 5, 1, 16)``, ``conv_b (16,)``, ``fc_w (3136, 10)``
indexed by NHWC-flattened pooled features, ``fc_b (10,)``. Images are
NHWC at the public functions. Inside, the conv runs in PyTorch's NCHW
(SAME padding = pad 2 for the 5x5 kernel, a 2x2 VALID max-pool), and the
pooled map is permuted back to NHWC before the flatten. The conv and pool
are XLA ops in the JAX package (no Pallas kernel), so they stay
``F.conv2d``/``F.max_pool2d`` here, and the backward is autograd.

On the card the conv runs with cuDNN switched off (``_plain_conv``), in
PyTorch's own im2col + matrix-product convolution with TF32 off. cuDNN's
weight-gradient algorithms, the default and the deterministic ones alike,
leave ``conv_w``'s gradient about 8e-5 relative from a float64 sum, where
the CPU's is about 2e-6; in the elastic-SGD demo that flips block top-k
picks and drifts the loss from the CPU run's. Without cuDNN the card's
losses stay within about 2e-7 of the CPU's, at a little more time per
iteration (PERF.md has both measurements).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.mlitb_cnn import CNN_EXTRAS, CNNExtras
from repro_torch.kernels.runtime import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def init_params(seed: int = 0, ex: CNNExtras = CNN_EXTRAS, *,
                device: DeviceLike = "cuda") -> Params:
    """Random weights from ``torch.Generator().manual_seed(seed)``, drawn
    on the CPU and moved to ``device``. Same shapes and scales as the JAX
    ``init_params``; the numbers differ (tests carry JAX weights across
    with ``checkpoint.convert.cnn_params_from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    fan_in = ex.kernel * ex.kernel * ex.channels
    feat = ex.conv_filters * (ex.image_hw // ex.pool) ** 2
    p = {
        "conv_w": torch.randn(ex.kernel, ex.kernel, ex.channels,
                              ex.conv_filters, generator=gen)
        * fan_in ** -0.5,
        "conv_b": torch.zeros(ex.conv_filters),
        "fc_w": torch.randn(feat, ex.n_classes, generator=gen)
        * feat ** -0.5,
        "fc_b": torch.zeros(ex.n_classes),
    }
    return {k: v.to(dev) for k, v in p.items()}


def _plain_conv():
    """cuDNN off (the conv's forward and backward both read the flag);
    TF32 stays off as ``resolve_device`` set it."""
    return torch.backends.cudnn.flags(enabled=False, allow_tf32=False)


def forward(params: Params, images: torch.Tensor,
            ex: CNNExtras = CNN_EXTRAS) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, n_classes)."""
    x = images.permute(0, 3, 1, 2)                          # NCHW
    w = params["conv_w"].permute(3, 2, 0, 1)                # HWIO -> OIHW
    with _plain_conv():
        x = F.conv2d(x, w, params["conv_b"], padding=ex.kernel // 2)
    x = F.max_pool2d(F.relu(x), ex.pool, ex.pool)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)       # NHWC flatten
    return x @ params["fc_w"] + params["fc_b"]


def loss_and_grad(params: Params, images: torch.Tensor, labels: torch.Tensor,
                  ex: CNNExtras = CNN_EXTRAS
                  ) -> Tuple[torch.Tensor, Params, torch.Tensor]:
    """Returns (sum_nll, grad of SUM loss, n_correct). Sum (not mean) so the
    master's weighted reduce (MLitB step c) can divide by the global
    count. The returned values stay on the device (no host sync)."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad(), _plain_conv():
        logits = forward(p, images, ex)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, labels.long()[:, None],
                                  dim=-1)[:, 0]
        loss = torch.sum(lse - ll)
        grads = torch.autograd.grad(loss, [p[k] for k in p])
    correct = torch.sum(torch.argmax(logits.detach(), -1) == labels.long())
    return loss.detach(), dict(zip(p, grads)), correct
