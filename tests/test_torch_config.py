"""The port's two-level YAML config (``ptype_tpu_torch.config``)
against the reference's: every framework YAML under ``examples/*/``
loads to equal field values in both packages, the same invalid configs
raise ``ConfigError`` in both (unset ``CONFIG`` included), and the port
reads a file only when asked — with no ``yaml`` module it raises
``ConfigError`` naming it, while configs built in code still work.
Values are compared exactly (``dataclasses.asdict``)."""

import builtins
import dataclasses
import pathlib
import sys

import pytest

from ptype_tpu import config as jconfig
from ptype_tpu_torch import config as tconfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted(ROOT.glob("examples/*/*.yaml"))


def _loader(mod, path):
    """A framework config (it names a platform file) or a platform one."""
    if "platform_config_file" in path.read_text():
        return mod.config_from_file(str(path))
    return mod.platform_config_from_file(str(path))


def test_the_examples_are_found():
    assert len(EXAMPLES) >= 12


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_example_loads_equal_in_both_packages(path):
    want = dataclasses.asdict(_loader(jconfig, path))
    got = dataclasses.asdict(_loader(tconfig, path))
    assert got == want


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


#: (name, framework yaml, platform yaml or None, message both raise).
INVALID = [
    ("missing_file", None, None, "failed to read cluster config"),
    ("bad_yaml", "service_name: [unclosed\n", None, "failed to read yaml"),
    ("missing_platform", "service_name: s\nnode_name: n\nport: 1\n"
     "platform_config_file: absent.yaml\n", None,
     "failed to read platform config"),
    ("bad_address", "service_name: s\nnode_name: n\nport: 1\n"
     "platform_config_file: p.yaml\n",
     "name: n\ncoordinator_address: not-an-address\n",
     "coordinator_address"),
    ("port_range", "service_name: s\nnode_name: n\nport: 1\n"
     "platform_config_file: p.yaml\n",
     "name: n\ncoordinator_address: 127.0.0.1:70000\n", "out of range"),
    ("unknown_field", "service_name: s\nnode_name: n\nport: 1\n"
     "typo_field: 3\n", None, "unknown fields"),
    ("unknown_platform_field", "service_name: s\nnode_name: n\nport: 1\n"
     "platform_config_file: p.yaml\n", "name: n\nbogus: 1\n",
     "unknown fields"),
    ("no_service", "node_name: n\nport: 1\n", None, "service_name"),
    ("bad_mesh_axis", "service_name: s\nnode_name: n\nport: 1\n"
     "platform_config_file: p.yaml\n", "name: n\nmesh_axes:\n  data: 0\n",
     "mesh axis"),
    ("process_id", "service_name: s\nnode_name: n\nport: 1\n"
     "platform_config_file: p.yaml\n",
     "name: n\nnum_processes: 2\nprocess_id: 2\n", "process_id"),
    ("lease_ttl", "service_name: s\nnode_name: n\nport: 1\n"
     "platform_config_file: p.yaml\n", "name: n\nlease_ttl: 0\n",
     "lease_ttl"),
    ("not_a_mapping", "- a\n- b\n", None, "must be a YAML mapping"),
]


@pytest.mark.parametrize("case", INVALID, ids=lambda c: c[0])
def test_invalid_config_raises_in_both_packages(tmp_path, case):
    _, text, platform, match = case
    path = (str(tmp_path / "absent.yaml") if text is None
            else _write(tmp_path, "c.yaml", text))
    if platform is not None:
        _write(tmp_path, "p.yaml", platform)
    with pytest.raises(jconfig.ConfigError, match=match):
        jconfig.config_from_file(path)
    with pytest.raises(tconfig.ConfigError, match=match):
        tconfig.config_from_file(path)


def test_config_from_env_in_both_packages(tmp_path, monkeypatch):
    path = _write(tmp_path, "c.yaml", "service_name: s\nnode_name: n\n"
                  "port: 5\nplatform_config_file: p.yaml\n")
    _write(tmp_path, "p.yaml", "name: n\nlease_ttl: 1.5\n")
    monkeypatch.setenv("CONFIG", path)
    assert (dataclasses.asdict(tconfig.config_from_env())
            == dataclasses.asdict(jconfig.config_from_env()))
    monkeypatch.delenv("CONFIG")
    for mod in (jconfig, tconfig):
        with pytest.raises(mod.ConfigError, match="CONFIG"):
            mod.config_from_env()


def test_validation_errors_match_the_reference():
    for mod in (jconfig, tconfig):
        with pytest.raises(mod.ConfigError, match="service_name"):
            mod.Config(node_name="n").validate()
        with pytest.raises(mod.ConfigError, match="dial_timeout"):
            mod.PlatformConfig(dial_timeout=0).validate()
    assert (dataclasses.asdict(tconfig.Config())
            == dataclasses.asdict(jconfig.Config()))


def test_no_yaml_module_raises_config_error_naming_it(tmp_path,
                                                      monkeypatch):
    path = _write(tmp_path, "c.yaml", "service_name: s\nnode_name: n\n")
    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "yaml", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(tconfig.ConfigError, match="yaml"):
        tconfig.config_from_file(path)
    cfg = tconfig.Config(service_name="s", node_name="n")
    cfg.validate()
