"""The configuration check: what the program runs from a configuration
file (``drivers.program_config``) against the program's registered
configuration of the file's name, field by field, and the program's
parameter tree for the file against the reference's (``layout``).

Fields are compared as dotted paths of ``dataclasses.asdict``
(``n_layers``, ``ssm.chunk``, ``moe.n_experts``). A path is skipped where
it, or a group that holds it, is listed in the entry's ``reduced``: the
cut is declared. A field the file does not name is compared at the value
the program gives it, its default, since that is what the program runs
(the reference reads the file itself, so a key that its family reads has
to be there). Each ``reduced``
entry names a field path of the program's configuration or a key the
file holds (a number of the source's own config), and is a key of the
file's ``changed``, so a misspelt entry cannot hide a difference.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Dict, List, Set

from perfbench.drivers import dataclass_type, program_config

_ABSENT = "(absent)"


def flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    """``{"a": {"b": 1}}`` as ``{"a.b": 1}``; a group that is None stays a
    leaf of its own name."""
    out: Dict[str, object] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def field_paths(cls, prefix: str = "") -> Set[str]:
    """Every field path of dataclass ``cls``, each nested group's fields
    included (``moe``, ``moe.n_experts``, ...)."""
    types = typing.get_type_hints(cls)
    out: Set[str] = set()
    for f in dataclasses.fields(cls):
        path = prefix + f.name
        out.add(path)
        sub = dataclass_type(types[f.name])
        if sub is not None:
            out |= field_paths(sub, path + ".")
    return out


def _declared(path: str, reduced) -> bool:
    return any(path == r or path.startswith(r + ".") for r in reduced)


def _shapes(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shapes(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tuple(v)


def differences(entry: dict, cfg: dict) -> List[str]:
    """What keeps configuration file ``cfg`` (the dictionary of
    ``entry["file"]``) from being the program's registered configuration
    ``entry["name"]`` cut as ``entry["reduced"]`` declares; empty where
    nothing does."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.transformer import param_shapes

    from perfbench.reference.models import layout

    out: List[str] = []
    reduced = list(entry["reduced"])
    if cfg.get("name") != entry["name"]:
        out.append(f"name: the file names {cfg.get('name')!r}, the entry "
                   f"{entry['name']!r}")
    paths = field_paths(ArchConfig)
    changed = cfg.get("changed", {})
    for r in reduced:
        if r not in paths and r not in cfg:
            out.append(f"reduced: {r!r} is no field of the program's "
                       "configuration and no key of the file")
        if r not in changed:
            out.append(f"reduced: {r!r} is not a key of the file's changed")
    try:
        prog = program_config(cfg)
    except TypeError as e:
        return out + [f"the file makes no program configuration: {e}"]
    try:
        registered = flatten(dataclasses.asdict(get_config(entry["name"])))
    except KeyError:
        return out + [f"the program registers no configuration "
                      f"{entry['name']!r}"]
    ours = flatten(dataclasses.asdict(prog))
    for p in sorted(set(ours) | set(registered)):
        if _declared(p, reduced):
            continue
        a, b = ours.get(p, _ABSENT), registered.get(p, _ABSENT)
        if a != b:
            out.append(f"{p}: the file runs {a!r}, the registered "
                       f"configuration has {b!r}")
    try:
        reference = {path: tuple(s) for path, s, _ in layout(cfg)}
    except KeyError as e:
        return out + [f"the reference reads {e}, which the file lacks"]
    program = dict(_shapes(param_shapes(prog)))
    for p in sorted(set(program) | set(reference)):
        a, b = program.get(p), reference.get(p)
        if a != b:
            out.append(f"parameter {p}: the program's shape {a}, the "
                       f"reference's {b}")
    return out
