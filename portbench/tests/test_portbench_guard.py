"""What the harness may load, and what it refuses to run without."""

import ast
import json
import os
import shutil
import subprocess
import sys

from portbench import bench

PB = bench.ROOT / "portbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_imports_jax_the_jax_package_or_benchmarks():
    for path in PB.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, \
            path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").rglob("*.py"):
        assert not any(m.split(".")[0] == "repro_torch"
                       for m in _imports(path)), path


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


DRY = ["--workload", "granite-8b.fleet_zipf", "--seed", "2147483648",
       "--seconds", "8", "--trace", "0", "--device", "cpu"]


def test_a_dry_run_prints_one_result_naming_the_cpu_and_loads_no_jax():
    code = ("import sys, json, runpy; sys.argv = ['run.py'] + "
            f"{DRY!r}; "
            "rc = 0\n"
            "try:\n"
            f"    runpy.run_path({str(PB / 'run.py')!r}, "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})), file=sys.stderr)\n"
            "sys.exit(rc)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=bench.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["device"]["platform"] == "cpu"
    assert result["correct"] is True and result["attempted"] > 0
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device", "checks"}
    assert list(result)[-1] == "checks"
    mods = set(json.loads(p.stderr.strip().splitlines()[-1]))
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_a_loaded_jax_package_ends_the_run_without_a_result():
    code = ("import sys, types, runpy; "
            "sys.modules['repro'] = types.ModuleType('repro'); "
            f"sys.argv = ['run.py'] + {DRY!r}; "
            f"runpy.run_path({str(PB / 'run.py')!r}, run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=bench.ROOT, timeout=600)
    assert p.returncode == 3
    assert "forbidden modules loaded: ['repro']" in p.stderr
    assert not p.stdout.strip()


def test_without_the_program_the_run_fails_and_prints_nothing(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", *DRY],
                       capture_output=True, text=True, env=_env(),
                       cwd=tmp_path, timeout=600)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a card is present")
    args = [a if a != "cpu" else "cuda" for a in DRY]
    p = subprocess.run([sys.executable, str(PB / "run.py"), *args],
                       capture_output=True, text=True, env=_env(),
                       cwd=bench.ROOT, timeout=600)
    assert p.returncode == 2
    assert not p.stdout.strip()
