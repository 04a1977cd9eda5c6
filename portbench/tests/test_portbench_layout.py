"""A configuration, a mix and a metric are added with new files only."""

import json
import shutil

from portbench import bench, check, reference
from portbench.metrics import counts


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


RECORDED = '''"""granite-8b's reference and counts, recording their calls."""

from portbench.metrics import counts
from portbench.reference import model, weights

CALLS = []


def draw(cfg, seed, device):
    CALLS.append("draw")
    return weights.draw(cfg, seed, device)


def logits(cfg, params, tokens, positions, *, prefill_len, fp8=False):
    CALLS.append("logits")
    return model.logits(cfg, params, tokens, positions,
                        prefill_len=prefill_len, fp8=fp8)


def flash_call(cfg, B, S):
    CALLS.append("flash_call")
    return tuple(2 * n for n in counts.flash_call.__wrapped__(cfg, B, S))
'''


def test_a_configuration_brings_its_own_reference_and_counts(tmp_path):
    root = _copy(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "granite-8b.json").read_text())
    cfg["reference"] = "recorded"
    (pb / "configs" / "granite-8b-own.json").write_text(json.dumps(cfg))
    (pb / "reference" / "recorded.py").write_text(RECORDED)
    (pb / "limits" / "own.steady.json").write_text(
        json.dumps({"gen_gap": 1.0, "logit_err": 0.08}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "granite-8b-own", "source": "x",
                         "file": "portbench/configs/granite-8b-own.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "own.steady", "config": "granite-8b-own",
                           "traffic": "serve_steady", "chips": 1,
                           "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    seed = 2147483777
    args = bench.parse(["--workload", "own.steady", "--seed", str(seed),
                        "--seconds", "1.5", "--device", "cpu"])
    cell, run, system = bench.setup(args, 0.0, root)
    own = reference.module(run.cfg)
    assert own.__file__ == str(pb / "reference" / "recorded.py")
    bench.drive(system, run, 1.5, False)
    system.close()
    picked = check.sample(run.records, run.outputs, run.mix, seed)
    assert picked
    own.CALLS.clear()
    gaps = check.reference_gaps(run.cfg, picked, run.outputs, seed, "cpu",
                                last_logits=run.last_logits)
    assert own.CALLS.count("draw") == 1
    assert own.CALLS.count("logits") == len(picked)
    assert check.judge(gaps, 0, cell.limits)[0]
    # the same module code on the same weights: today's readings
    plain = {k: v for k, v in run.cfg.items()
             if k not in ("reference", reference.FILE_KEY)}
    assert check.reference_gaps(plain, picked, run.outputs, seed, "cpu",
                                last_logits=run.last_logits) == gaps

    own.CALLS.clear()
    fl_s, fl_n, dec_s, dec_n = counts.kernel_work(
        run.cfg, run.batch, run.records, run.mix["prefill_len"])
    assert own.CALLS and set(own.CALLS) == {"flash_call"}
    want = counts.kernel_work(plain, run.batch, run.records,
                              run.mix["prefill_len"])
    assert (fl_s, fl_n, dec_s, dec_n) == (2 * want[0], *want[1:])
    assert counts.body_params(run.cfg) == counts.body_params(plain)


def test_a_metric_suffix_finds_the_readers_file():
    assert bench.reader_path(bench.ROOT, "serve_mfu.fleet").name == \
        "serve_mfu.py"
    assert bench.reader_path(bench.ROOT, "setup_s").name == "setup_s.py"
