"""The port's copy of the architecture registry against the JAX
package's: for every registered arch, ``get_config(name)`` and
``.reduced()`` field by field, ``n_params``, ``n_active_params``,
``block_pattern``, ``attention_free``, ``supports_long_decode``,
``with_sliding_window``, and ``list_archs`` / ``ASSIGNED_ARCHS``.
Configs are pure data, so everything is equal, not close.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as J  # noqa: E402
from repro.configs.all_configs import ASSIGNED_ARCHS as J_ASSIGNED  # noqa: E402
import repro_torch.configs as T  # noqa: E402
from repro_torch.configs.all_configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

NAMES = J.list_archs()


def _fields(cfg) -> dict:
    """Every field, sub-configs included, as plain data."""
    return dataclasses.asdict(cfg)


def test_registry_lists_the_same_archs():
    assert T.list_archs() == J.list_archs()
    assert len(NAMES) == 12
    assert ASSIGNED_ARCHS == J_ASSIGNED


@pytest.mark.parametrize("name", NAMES)
def test_config_and_reduced_equal_reference(name):
    a, b = J.get_config(name), T.get_config(name)
    for ja, tb in ((a, b), (a.reduced(), b.reduced())):
        assert _fields(tb) == _fields(ja)
        assert tb.n_params() == ja.n_params()
        assert tb.n_active_params() == ja.n_active_params()
        assert tb.block_pattern() == ja.block_pattern()
        assert tb.attention_free == ja.attention_free
        assert tb.supports_long_decode == ja.supports_long_decode
        assert _fields(tb.with_sliding_window(64)) \
            == _fields(ja.with_sliding_window(64))


def test_reduced_family_settings():
    """The settings the CPU tests rely on: generous MoE capacity, the
    small SSM, a 4-layer hybrid of period 2."""
    moe = T.get_config("llama4-scout-17b-a16e").reduced().moe
    assert (moe.n_experts, moe.experts_per_token, moe.d_ff_expert,
            moe.capacity_factor) == (4, 1, 128, 4.0)
    ssm = T.get_config("mamba2-780m").reduced().ssm
    assert (ssm.d_state, ssm.head_dim, ssm.chunk) == (16, 32, 16)
    hyb = T.get_config("zamba2-7b").reduced()
    assert (hyb.hybrid_attn_period, hyb.n_layers) == (2, 4)
    assert hyb.block_pattern() == ("ssm", "hattn", "ssm", "hattn")


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "mamba2-780m",
                                  "zamba2-7b", "qwen3-4b"])
def test_param_count_of_full_width_tree(name):
    """The tree ``init_params`` would make at full width (on the meta
    device, nothing allocated): MoE and dense trees hold exactly
    ``n_params``; an SSM block also holds its conv bias, which the
    analytic count (the reference's) leaves out."""
    cfg = T.get_config(name)
    tree = t_tf.abstract_params(cfg)

    def count(t):
        return sum(count(v) if isinstance(v, dict) else v.numel()
                   for v in t.values())
    extra = 0
    if cfg.ssm is not None:
        conv_dim = cfg.ssm.d_inner(cfg.d_model) + 2 * cfg.ssm.d_state
        extra = conv_dim * sum(k == "ssm" for k in cfg.block_pattern())
    assert count(tree) == cfg.n_params() + extra


@pytest.mark.parametrize("name", ["paligemma-3b", "whisper-large-v3"])
def test_vlm_and_audio_are_data_only(name):
    cfg = T.get_config(name).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP C7"):
        t_tf.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP C7"):
        t_tf.param_shapes(cfg)
