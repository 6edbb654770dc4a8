"""The paper's own use-case model: a small convolutional NN on 28x28 images
(copy of ``repro.configs.mlitb_cnn``).

MLitB §3.5: "a 28x28 input layer connected to 16 convolution filters (with
pooling), followed by a fully connected output layer" — trained on MNIST
with distributed synchronized SGD + AdaGrad. The model the port's
training slice (``launch/elastic_sgd.py``) trains at full width.
"""
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, register


@dataclass(frozen=True)
class CNNExtras:
    image_hw: int = 28
    channels: int = 1
    conv_filters: int = 16
    kernel: int = 5
    pool: int = 2
    n_classes: int = 10


@register("mlitb-cnn")
def mlitb_cnn() -> ArchConfig:
    # ArchConfig is transformer-shaped; the CNN reuses it as a thin carrier
    # (d_model = flattened feature dim after conv+pool, vocab = n_classes).
    return ArchConfig(
        name="mlitb-cnn",
        arch_type="cnn",
        n_layers=1,
        d_model=16 * 14 * 14,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=10,
        param_dtype="float32",
        activ_dtype="float32",
        citation="MLitB paper §3.5 (Meeds et al., 2014)",
    )


CNN_EXTRAS = CNNExtras()
