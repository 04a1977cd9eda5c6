"""The end-to-end readers take the whole window."""

import math

import pytest

from portbench import bench


def _run(records, colds=(), window_s=10.0, closed=False,
         cell="granite-8b.fleet_zipf"):
    cell = bench.Cell(cell)
    run = bench.Run(cell, cell.cfg, cell.mix, "cuda")
    run.records, run.colds = list(records), list(colds)
    run.window_s, run.closed = window_s, closed
    return cell, run


def _rec(i, lat, ok=True, path="warm", new=32, entry="generate"):
    return {"i": i, "latency_s": lat, "ok": ok, "path": path if ok else None,
            "new_tokens": new, "entry": entry, "prompt_len": 128,
            "built": []}


def _read(cell, run, name):
    return cell.readers[name].read(run)


def test_p90_takes_every_invocation_due_failed_ones_included():
    recs = [_rec(i, 1.0) for i in range(18)] + [_rec(18, 5.0),
                                                _rec(19, 9.0, ok=False)]
    steady = "olmoe-1b-7b.serve_steady"
    cell, run = _run(recs, cell=steady)
    # nearest rank: the 18th of 20 sorted latencies
    assert _read(cell, run, "latency_p90_s") == 1.0
    recs[0]["latency_s"] = 7.0
    cell, run = _run(recs, cell=steady)
    assert _read(cell, run, "latency_p90_s") == 5.0
    _, run = _run(recs, closed=True, cell=steady)
    assert _read(cell, run, "latency_p90_s") is None


def test_tokens_per_s_counts_completed_tokens_over_the_whole_window():
    recs = [_rec(i, 1.0) for i in range(10)] + [
        _rec(10, 1.0, entry="score", new=0), _rec(11, 1.0, ok=False)]
    cell, run = _run(recs, window_s=12.5)
    assert _read(cell, run, "fleet_tokens_per_s") == pytest.approx(
        10 * 4 * 32 / 12.5)
    cell, run = _run(recs, window_s=12.5, cell="olmoe-1b-7b.serve_steady")
    assert _read(cell, run, "tokens_per_s") == pytest.approx(
        10 * 4 * 32 / 12.5)


def test_cold_start_s_is_the_mean_over_every_cold_start():
    colds = [{"cold_start_s": s, "by_group": {"compile": c, "weights": w}}
             for s, c, w in ((0.8, 0.5, 0.2), (1.0, 0.6, 0.3),
                             (0.6, 0.4, 0.1))]
    recs = [_rec(0, 1, path="cold"), _rec(1, 1, path="cold"),
            _rec(2, 1), _rec(3, 1, path="cold")]
    cell, run = _run(recs, colds)
    assert _read(cell, run, "cold_start_s.fleet") == pytest.approx(0.8)
    assert _read(cell, run, "compile_s.fleet") == pytest.approx(0.5)
    assert _read(cell, run, "weights_s.fleet") == pytest.approx(0.2)
    assert _read(cell, run, "cold_share.fleet") == pytest.approx(75.0)
    cell, run = _run(recs[2:3])
    assert _read(cell, run, "cold_start_s.fleet") is None


def test_device_readers_read_nothing_without_a_trace():
    cell, run = _run([_rec(0, 1.0)])
    for name in ("serve_mfu.fleet", "flash_roofline.fleet",
                 "decode_roofline.fleet", "idle_share.fleet",
                 "peak_mem_gib"):
        assert _read(cell, run, name) is None


def test_a_cpu_run_reports_no_time_under_a_metric_name():
    cell, run = _run([_rec(0, 1.0, path="cold")],
                     [{"cold_start_s": 1.0, "by_group": {}}])
    run.device = "cpu"
    run.setup_s = 3.0
    got = bench.evaluate(run, cell.end_to_end + cell.per_layer)
    assert set(got) == {"cold_share.fleet"}
    assert not math.isnan(got["cold_share.fleet"]["value"])
