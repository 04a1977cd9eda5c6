"""A configuration, a mix and a metric are added with new files only."""

import json
import shutil

from portbench import bench


def _copy(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(bench.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = _copy(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "granite-8b.json").read_text())
    (pb / "configs" / "granite-8b-alt.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "serve_steady.json").read_text())
    mix.update(rate_per_s=50.0, trace_seed=99)
    (pb / "traffic" / "steady_fast.json").write_text(json.dumps(mix))
    (pb / "metrics" / "invocations.py").write_text(
        'SOURCE = "program_counter"\n\n\ndef read(run):\n'
        '    return len(run.records)\n')
    (pb / "limits" / "alt.fast.json").write_text(
        json.dumps({"gen_gap": 1.0}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "granite-8b-alt", "source": "x",
                         "file": "portbench/configs/granite-8b-alt.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "alt.fast", "config": "granite-8b-alt",
                           "traffic": "steady_fast", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "invocations.fast", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "pool", "moves": "tokens_per_s",
                           "workloads": ["alt.fast"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    args = bench.parse(["--workload", "alt.fast", "--seed", "2147483999",
                        "--seconds", "1.5", "--device", "cpu"])
    cell, run, system = bench.setup(args, 0.0, root)
    assert cell.mix["rate_per_s"] == 50.0
    bench.drive(system, run, 1.5, False)
    got = bench.evaluate(run, cell.per_layer)
    assert got["invocations.fast"]["value"] == len(run.records) > 5
    assert got["invocations.fast"]["unit"] == "count"


def test_a_metric_suffix_finds_the_readers_file():
    assert bench.reader_path(bench.ROOT, "serve_mfu.fleet").name == \
        "serve_mfu.py"
    assert bench.reader_path(bench.ROOT, "setup_s").name == "setup_s.py"
