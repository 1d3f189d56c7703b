"""The port's .ini loader against the JAX package's, on every shipped config."""

import dataclasses
import glob
import os

import pytest

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu_torch.config import (
    load_options as torch_load, network_config as torch_netcfg, parse_ini)
from test_torch_helpers import ROOT, SYNTH_INI

CONFIGS = sorted(os.path.relpath(p, ROOT) for p in
                 glob.glob(os.path.join(ROOT, "configs", "**", "*.ini"), recursive=True))


@pytest.mark.parametrize("config", CONFIGS)
def test_config_loads_same_values(config):
    path = os.path.join(ROOT, config)
    j = dataclasses.asdict(jax_load(path))
    t = dataclasses.asdict(torch_load(path))
    assert j == t


def test_synth_spheres_every_key_accounted():
    raw = parse_ini(SYNTH_INI)
    opt = torch_load(SYNTH_INI, hash_scatter_impl="mixed")
    for k, v in raw.items():
        got = getattr(opt, k)
        assert got == (tuple(v) if isinstance(v, list) else v), k
    assert opt.hash_scatter_impl == "mixed" and opt.encoding_pos == "rolled_tiled"


@pytest.mark.parametrize("custom_grad", ["auto", "on", "off"])
def test_network_config_matches(custom_grad):
    kw = dict(hash_scatter_impl="mixed", hash_custom_grad=custom_grad)
    j = jax_netcfg(jax_load(SYNTH_INI, **kw))
    t = torch_netcfg(torch_load(SYNTH_INI, **kw))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    js, ts = j.hash_spec, t.hash_spec
    for f in ("offsets", "resolutions", "scales", "scale_factor", "indexing",
              "interpolation", "custom_grad", "scatter_impl"):
        assert getattr(js, f) == getattr(ts, f), f


def test_unknown_key_raises(tmp_path):
    p = tmp_path / "bad.ini"
    p.write_text("bound = 1.0\nnot_an_option = 3\n")
    with pytest.raises(ValueError, match="not_an_option"):
        torch_load(str(p))


def test_unknown_override_raises():
    with pytest.raises(ValueError, match="no_such_flag"):
        torch_load(SYNTH_INI, no_such_flag=1)
