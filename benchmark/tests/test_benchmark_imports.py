"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), the
reference loads nothing of the program, and a run without a card, or in a
directory of the benchmark's files alone, prints no result."""

import os
import shutil
import subprocess
import sys

from cpu_cells import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "envidr_tpu"}


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_banned_check_compares_whole_names():
    from benchmark import harness
    assert set(harness.BANNED) == BANNED
    fake = type(sys)("probe")
    added = [m for m in ("envidr_tpu_torch", "envidr_tpux.ops") if m not in sys.modules]
    try:
        for m in added:
            sys.modules[m] = fake
        assert not harness.banned_modules()
        sys.modules["envidr_tpu.ops"] = fake
        assert harness.banned_modules() == ["envidr_tpu"]
    finally:
        sys.modules.pop("envidr_tpu.ops", None)
        for m in added:
            sys.modules.pop(m, None)


def test_a_run_loads_no_jax():
    mods = _top_level_after(
        "import sys; sys.path.insert(0, 'benchmark/tests')\n"
        "from cpu_cells import run_cell\n"
        "line, _ = run_cell('hash_train')\n"
        "assert line['correct']")
    assert not mods & BANNED, mods & BANNED
    assert "envidr_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = _top_level_after(
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.reference.model, benchmark.reference.params, benchmark.reference.ckpt\n"
        "import benchmark.scene")
    assert not mods & (BANNED | {"envidr_tpu_torch"}), mods & (BANNED | {"envidr_tpu_torch"})


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cp_train",
                          "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cp_train",
                          "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
