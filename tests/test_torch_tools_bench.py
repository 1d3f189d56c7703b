"""The micro-benchmark entry points of ``envidr_tpu_torch.tools``: each runs
on the CPU when asked, at tiny shapes, and prints every row name of the JAX
script it ports; without a device and without a card each raises."""

import importlib
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from envidr_tpu_torch.ops import _cuda
from envidr_tpu_torch.tools._timing import Bench
from test_torch_helpers import ROOT, tool_row_templates
from test_torch_isolation import IMPORT_RE, SOURCES

TINY = {
    "bench_scatter": ["--B", "2048", "--S", "4096", "--L", "2", "--s-small", "256",
                      "--e2e-iters", "1"],
    "bench_scatter2": ["--B", "2048", "--S", "4096", "--L", "2"],
    "bench_gs4": ["--B", "2048", "--S", "4096"],
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_main_prints_every_row_of_the_jax_script(name, capsys):
    mod = importlib.import_module(f"envidr_tpu_torch.tools.{name}")
    summary = mod.main(["--iters", "1", *TINY[name]], device="cpu")
    out = capsys.readouterr().out
    names = [r["name"] for r in summary["rows"]]
    assert summary["device"]["type"] == "cpu" and summary["timer"] == "host"
    templates = tool_row_templates(f"{name}.py")
    assert len(templates) >= 3
    for t in templates:
        assert any(re.fullmatch(t, n) for n in names), f"no row for {t!r} in {names}"
    for n in names:
        assert any(re.fullmatch(t, n) for t in templates), f"row {n!r} is not the script's"
        assert n in out
    assert all(r["ms"] > 0 for r in summary["rows"])
    assert f"{name} summary: " in out


@pytest.mark.parametrize("name", sorted(TINY))
def test_main_without_device_or_card_raises(name, monkeypatch):
    mod = importlib.import_module(f"envidr_tpu_torch.tools.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--iters", "1", *TINY[name]])


def test_isolation_scan_covers_the_tools_subpackage():
    tools = {p.name for p in SOURCES if p.parent.name == "tools"
             and p.parent.parent.name == "envidr_tpu_torch"}
    assert {"__init__.py", "_timing.py", *(f"{n}.py" for n in TINY)} <= tools
    # the JAX package's tools/ is never imported, by name or relatively
    assert IMPORT_RE.search("from tools import bench_scatter")
    for p in SOURCES:
        assert "sys.path" not in Path(p).read_text() or p.name == "chip_smoke.py", p
    assert not any(Path(ROOT, "tools") in Path(p).parents for p in SOURCES)


def test_bench_rows_record_their_own_kernel_launches(monkeypatch, capsys):
    fake = SimpleNamespace(symbol="fake_launch", launches=0)
    monkeypatch.setattr(_cuda, "LIBRARIES", [fake])

    def launch():
        fake.launches += 1

    bench = Bench("t", torch.device("cpu"), iters=3, warmup=1)
    bench.run("launches", launch, 1, 1)
    bench.run("launches none", lambda: None, 1, 1)
    assert [r["launches"] for r in bench.summary()["rows"]] == [{"fake_launch": 4}, {}]
