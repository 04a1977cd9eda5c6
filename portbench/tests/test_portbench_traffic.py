"""The traffic generators: deterministic, and true to their parameters."""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from portbench.traffic import draw
from portbench import bench

TRAFFIC = Path(bench.ROOT) / "portbench" / "traffic"


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def _gen(mix):
    return bench.load_module(TRAFFIC / f"gen_{mix['generator']}.py")


@pytest.mark.parametrize("name", ["fleet_zipf", "serve_steady"])
def test_schedule_is_the_same_every_time(name):
    mix = _mix(name)
    a = list(itertools.islice(_gen(mix).schedule(mix, 30.0), 200))
    b = list(itertools.islice(_gen(mix).schedule(mix, 30.0), 200))
    assert a == b and len(a) > 5


def test_open_schedule_prefix_does_not_depend_on_length():
    mix = _mix("serve_steady")
    short = _gen(mix).schedule(mix, 10.0)
    long = _gen(mix).schedule(mix, 40.0)
    assert long[:len(short)] == short
    assert all(inv["due_s"] < 10.0 for inv in short)
    assert long[len(short)]["due_s"] >= 10.0


def test_open_loop_arrivals_are_poisson_at_the_rate():
    mix = dict(_mix("serve_steady"), rate_per_s=2.0)
    invs = _gen(mix).schedule(mix, 5000.0)
    gaps = np.diff([inv["due_s"] for inv in invs])
    assert np.all(gaps >= 0)
    assert abs(gaps.mean() - 0.5) < 0.02
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05  # exponential


def test_sizes_functions_and_entries_match_the_mix():
    mix = _mix("fleet_zipf")
    invs = [draw.invocation(mix, i) for i in range(20000)]
    p = mix["prompt"]
    lens = {inv["prompt_len"] for inv in invs}
    # every prompt is the published median, rounded up to round_to
    want_len = -(-p["median"] // p["round_to"]) * p["round_to"]
    assert lens == {want_len} == set(draw.prompt_lengths(p))
    assert mix["max_len"] >= want_len + mix["new_tokens"]
    shares = np.bincount([inv["function"] for inv in invs],
                         minlength=mix["functions"]) / len(invs)
    want = draw.zipf_probs(mix["functions"], mix["zipf_s"])
    assert np.allclose(shares, want, atol=0.01)
    assert abs(want[0] - 1 / sum(1 / k for k in range(1, 9))) < 1e-12
    score = np.mean([inv["entry"] == "score" for inv in invs])
    assert abs(score - mix["entries"]["score"]) < 0.005
    assert all(inv["new_tokens"] == (0 if inv["entry"] == "score"
                                     else mix["new_tokens"]) for inv in invs)


def test_log_normal_lengths_keep_their_median_and_clip():
    p = {"median": 256, "sigma": 0.6, "min": 128, "max": 1024,
         "round_to": 64}
    mix = {"trace_seed": 3, "entries": {"generate": 1.0}, "new_tokens": 4,
           "prompt": p}
    lens = np.array([draw.invocation(mix, i)["prompt_len"]
                     for i in range(20000)])
    assert lens.min() >= p["min"] and lens.max() <= p["max"]
    assert np.all(lens % p["round_to"] == 0)
    assert set(lens) <= set(draw.prompt_lengths(p))
    # the median rounds up to the next multiple of round_to
    assert p["median"] <= np.median(lens) <= p["median"] + p["round_to"]


def test_closed_loop_sends_the_same_sizes_endlessly():
    mix = _mix("fleet_zipf")
    it = _gen(mix).schedule(mix, 1.0)
    invs = list(itertools.islice(it, 500))
    assert all(inv["due_s"] is None for inv in invs)
    assert [(inv["prompt_len"], inv["function"], inv["entry"])
            for inv in invs] == \
        [(d["prompt_len"], d["function"], d["entry"])
         for d in (draw.invocation(mix, i) for i in range(500))]


def test_tokens_depend_on_the_run_seed_only():
    from portbench import system
    a = system.tokens_for(2**31 + 5, system.WINDOW, 3, 4, 64, 1000)
    b = system.tokens_for(2**31 + 5, system.WINDOW, 3, 4, 64, 1000)
    c = system.tokens_for(2**31 + 6, system.WINDOW, 3, 4, 64, 1000)
    assert a.shape == (4, 64) and np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 1000
