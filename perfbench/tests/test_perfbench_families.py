"""A model family is one module of ``perfbench/reference/families/``,
found by ``arch_type``: a family written as a new module alone resolves
through the layout, the weights, the FLOPs and the reference's training;
no other module of ``perfbench/`` names a family or compares
``arch_type``; and ``program_config`` builds every nested group of the
program's configuration from its field's type, so any registered
configuration, experts included, reaches the program whole."""
from __future__ import annotations

import ast
import dataclasses
import itertools
import math
import sys

import pytest

from perfbench.tests.support import CELLS, ROOT, harness

from repro_torch.configs import get_config, list_archs  # noqa: E402

from perfbench import flops, traffic, weights  # noqa: E402
from perfbench.drivers import program_config  # noqa: E402
from perfbench.reference import families  # noqa: E402
from perfbench.reference.models import layout  # noqa: E402
from perfbench.reference.train import follow_mesh  # noqa: E402

FAMILY_DIR = ROOT / "perfbench" / "reference" / "families"
TOY = "toymlp"
TOY_SOURCE = '''
"""Blocks of RMSNorm and a SwiGLU MLP, nothing else; ``WEIGHT`` x the
rows x |w_up|^2 as the family's own term."""
from perfbench.reference.families import (Loss, embedding_layout, head_nll,
                                          layer, mlp, rmsnorm)

WEIGHT = 0.0


def layout(cfg):
    d, L, ff = cfg["d_model"], cfg["n_layers"], cfg["d_ff"]
    return embedding_layout(cfg) + [
        ("blocks/ln/scale", (L, d), ("ones",)),
        ("blocks/mlp/w_gate", (L, d, ff), ("normal", d ** -0.5)),
        ("blocks/mlp/w_up", (L, d, ff), ("normal", d ** -0.5)),
        ("blocks/mlp/w_down", (L, ff, d), ("normal", ff ** -0.5))]


def nll_sum(p, cfg, tokens, labels, mask, num):
    x = p["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        h = rmsnorm(x, p["blocks/ln/scale"][i], cfg["norm_eps"])
        x = x + mlp(layer(p, "blocks/mlp/", i), h, num)
    nll, count = head_nll(p, cfg, x, labels, mask, num)
    extra = WEIGHT * count * p["blocks/mlp/w_up"].pow(2).sum() \\
        if WEIGHT else None
    return Loss(nll, count, extra)


def matmul_params(cfg):
    d = cfg["d_model"]
    return cfg["n_layers"] * 3 * d * cfg["d_ff"] + cfg["vocab_size"] * d


def mixing_flops_per_token(cfg, seq):
    return 0
'''


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy family's module, found on the families' lookup path."""
    import importlib

    (tmp_path / f"{TOY}.py").write_text(TOY_SOURCE)
    monkeypatch.setattr(families, "__path__",
                        [*families.__path__, str(tmp_path)])
    importlib.invalidate_caches()
    name = f"{families.__name__}.{TOY}"
    yield importlib.import_module(name)
    sys.modules.pop(name, None)


def test_a_family_from_a_new_module_alone(toy, monkeypatch):
    cfg = {"arch_type": TOY, "n_layers": 2, "d_model": 16, "d_ff": 24,
           "vocab_size": 64, "tie_embeddings": False, "norm_eps": 1e-5}
    spec = layout(cfg)
    names = [p for p, _, _ in spec]
    assert names[:3] == ["embed", "final_norm/scale", "lm_head"]
    p0 = weights.make(cfg, 2 ** 31 + 3, "cpu")
    assert {k: tuple(v.shape) for k, v in p0.items()} == \
        {p: s for p, s, _ in spec}
    assert flops.train_flops_per_token(cfg, 8) == \
        6 * (2 * 3 * 16 * 24 + 64 * 16)
    batches = list(itertools.islice(
        traffic.lm_batches(64, 4, 8, 500, 2 ** 31 + 3), 2))

    def follow():
        return follow_mesh(cfg, 2 ** 31 + 3, "cpu", batches, lr=0.01,
                           eps=1e-8, rows=2)
    plain = follow()
    assert len(plain.losses) == 2 and all(map(math.isfinite, plain.losses))
    assert set(plain.grad_norms) == set(plain.change_norms) == set(names)
    # the family's own term moves the gradient of the leaf it reads alone,
    # and the reported loss is the next-token loss without it
    monkeypatch.setattr(toy, "WEIGHT", 0.5)
    extra = follow()
    assert extra.losses[0] == plain.losses[0]
    for k in names:
        moved = extra.grad_norms[k] != plain.grad_norms[k]
        assert moved == (k == "blocks/mlp/w_up"), k


def test_an_unknown_family_names_its_missing_module():
    with pytest.raises(ValueError, match=r"perfbench\.reference\.families"
                                         r"\.nosuchfamily"):
        layout({"arch_type": "nosuchfamily"})


def test_only_family_modules_name_a_family():
    known = {p.stem for p in FAMILY_DIR.glob("*.py")} - {"__init__"}
    configured = {harness.load_cell(ROOT, n).config["arch_type"]
                  for n in CELLS}
    assert configured <= known, configured
    for path in (ROOT / "perfbench").rglob("*.py"):
        if FAMILY_DIR in path.parents:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant):
                assert node.value not in known, (path, node.value)
            elif isinstance(node, ast.Compare):
                assert not _reads_arch_type(node), (path, ast.unparse(node))


def _reads_arch_type(node) -> bool:
    """Whether ``node`` reads ``x["arch_type"]`` or ``x.arch_type``."""
    return any(isinstance(n, ast.Subscript)
               and isinstance(n.slice, ast.Constant)
               and n.slice.value == "arch_type"
               or isinstance(n, ast.Attribute) and n.attr == "arch_type"
               for n in ast.walk(node))


@pytest.mark.parametrize("arch", list_archs())
def test_program_config_round_trips(arch):
    c = get_config(arch)
    assert program_config(dataclasses.asdict(c)) == c
