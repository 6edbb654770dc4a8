"""The configuration check (``perfbench/config_check.py``) on copies of the
benchmark's configuration files: a cut passes where ``reduced`` declares
it and fails where it does not, a dotted entry skips only its field, a
field the file does not name is read at its default, an entry that names
nothing fails, and the CPU tests' cells are the registered ``.reduced()``
configurations."""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import pytest

from perfbench.tests.support import BENCH, ROOT, small_cell

from perfbench.config_check import differences  # noqa: E402
from perfbench.drivers import _dataclass, program_config  # noqa: E402

ENTRIES = {c["name"]: c for c in BENCH["configs"]}


def _copy(tmp_path, name, edit, reduced=(), changed=()):
    """Entry and file of configuration ``name``, the file edited by
    ``edit(cfg)``, written to ``tmp_path`` and read back; ``reduced`` and
    ``changed`` add to the entry's and the file's own."""
    entry = dict(ENTRIES[name])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    edit(cfg)
    cfg["changed"] = {**cfg["changed"], **{k: "cut" for k in changed}}
    entry["reduced"] = [*entry["reduced"], *reduced]
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return entry, json.loads(path.read_text())


def _group(cfg, path):
    """The dictionary that holds dotted ``path`` in ``cfg``, and its key."""
    *groups, key = path.split(".")
    for g in groups:
        cfg = cfg[g]
    return cfg, key


@pytest.mark.parametrize("listed", (True, False))
@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_a_depth_cut_passes_only_where_reduced_lists_it(tmp_path, name,
                                                       listed):
    def cut(cfg):
        cfg["n_layers"] = 10
    keys = ("n_layers",) if listed else ()
    entry, cfg = _copy(tmp_path, name, cut, reduced=keys, changed=keys)
    diffs = differences(entry, cfg)
    if listed:
        assert diffs == []
    else:
        assert diffs and all(d.startswith("n_layers:") for d in diffs)


@pytest.mark.parametrize("also", ((), ("ssm.d_state",)))
def test_a_dotted_entry_skips_only_its_field(tmp_path, also):
    def edit(cfg):
        for path, value in (("ssm.chunk", 256), *((p, 64) for p in also)):
            group, key = _group(cfg, path)
            group[key] = value
    entry, cfg = _copy(tmp_path, "mamba2-780m", edit, reduced=("ssm.chunk",),
                       changed=("ssm.chunk",))
    diffs = differences(entry, cfg)
    assert [d.split(":")[0] for d in diffs] == list(also)


@pytest.mark.parametrize("registered", (None, True))
def test_a_missing_key_is_read_at_its_default(tmp_path, monkeypatch,
                                              registered):
    """``qk_norm`` left out of the file: the program runs its default,
    False, which passes where the registered configuration has it and
    fails where it does not."""
    import repro_torch.configs as configs

    def drop(cfg):
        cfg.pop("qk_norm")
    entry, cfg = _copy(tmp_path, "mlitb-lm-100m", drop)
    if registered is not None:
        new = dataclasses.replace(configs.get_config("mlitb-lm-100m"),
                                  qk_norm=registered)
        monkeypatch.setattr(configs, "get_config", lambda n: new)
    diffs = differences(entry, cfg)
    assert [d.split(":")[0] for d in diffs] == (["qk_norm"] if registered
                                                else [])


def test_a_missing_key_the_reference_reads_is_named(tmp_path):
    """The program reads ``ssm.n_groups`` at its default, as registered;
    the reference reads the file, and the check names what it lacks."""
    def drop(cfg):
        group, key = _group(cfg, "ssm.n_groups")
        group.pop(key)
    entry, cfg = _copy(tmp_path, "mamba2-780m", drop)
    assert differences(entry, cfg) == [
        "the reference reads 'n_groups', which the file lacks"]


@pytest.mark.parametrize("entry_name,problem", (
    ("n_layer", "is no field"), ("n_layers", "is not a key")))
def test_a_reduced_entry_must_name_a_field_and_a_change(tmp_path, entry_name,
                                                        problem):
    def cut(cfg):
        cfg["n_layers"] = 10
    changed = (entry_name,) if problem == "is no field" else ()
    entry, cfg = _copy(tmp_path, "mlitb-lm-100m", cut,
                       reduced=(entry_name,), changed=changed)
    diffs = differences(entry, cfg)
    assert any(d.startswith(f"reduced: {entry_name!r} {problem}")
               for d in diffs), diffs


def test_a_source_key_the_file_holds_may_be_listed(tmp_path):
    """A number of the source's own config, held in the file under the
    source's key, may be listed beside the program's field it maps to."""
    def cut(cfg):
        cfg["num_hidden_layers"] = 10
        cfg["n_layers"] = 10
    keys = ("num_hidden_layers", "n_layers")
    entry, cfg = _copy(tmp_path, "mlitb-lm-100m", cut, reduced=keys,
                       changed=keys)
    assert differences(entry, cfg) == []


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_small_cell_is_the_registered_reduced_config(name):
    from repro_torch.configs import get_config

    cell = next(w["name"] for w in BENCH["workloads"] if w["config"] == name)
    assert program_config(small_cell(cell).config) == \
        get_config(name).reduced()


def test_small_cell_runs_what_the_file_says(monkeypatch):
    """A field that ``.reduced()`` leaves alone keeps the file's value."""
    from perfbench.tests import support

    real = support.harness.load_cell

    def load(root, name):
        cell = real(root, name)
        cell.config = {**cell.config, "rope_theta": 5e5}
        return cell
    monkeypatch.setattr(support.harness, "load_cell", load)
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["config"] == "mlitb-lm-100m")
    assert program_config(small_cell(cell).config).rope_theta == 5e5


@dataclasses.dataclass(frozen=True)
class Inner:
    kinds: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Outer:
    pattern: Optional[Tuple[Tuple[int, int], ...]] = None
    inner: Optional[Inner] = None
    plain: Optional[list] = None


def test_a_json_list_reaches_a_tuple_field_as_a_tuple():
    got = _dataclass(Outer, {"pattern": [[1, 2], [3, 4]],
                             "inner": {"kinds": ["m", "a"]},
                             "plain": [5]})
    assert got == Outer(((1, 2), (3, 4)), Inner(("m", "a")), [5])
    hash(got.pattern)
