"""The check catches a broken timed path: each fault a serving cell can
have, planted under a CPU dry run, makes ``correct`` false."""

import copy
import json

import numpy as np
import pytest

from portbench import bench, check


def _dry(capsys, workload="granite-8b.fleet_zipf", seconds="3"):
    rc = bench.main(["--workload", workload, "--seed", "2147483777",
                     "--seconds", seconds, "--trace", "0", "--device",
                     "cpu"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _break_outputs(monkeypatch, fault):
    from repro_torch.serving import engine
    serve = engine.ServingEngine._serve

    def broken(self, entry, tokens, max_new_tokens, extras):
        out = np.array(serve(self, entry, tokens, max_new_tokens, extras))
        return fault(out, entry, self.cfg.vocab)
    monkeypatch.setattr(engine.ServingEngine, "_serve", broken)


def _altered(out, entry, vocab):
    """A token (or a score's top logit) altered where it is produced."""
    if entry == "score":
        out[:, :, :] = out[:, :, ::-1]
    else:
        out[:, 1] = (out[:, 1] + 1) % vocab
    return out


def _half_batch(out, entry, vocab):
    """Half of the batch left out: its rows are the other half's."""
    out[2:] = out[:2]
    return out


@pytest.mark.parametrize("fault", [_altered, _half_batch])
@pytest.mark.parametrize("workload", ["granite-8b.fleet_zipf",
                                      "olmoe-1b-7b.serve_steady"])
def test_a_broken_output_is_not_correct(capsys, monkeypatch, fault,
                                        workload):
    assert _dry(capsys, workload)["correct"] is True
    _break_outputs(monkeypatch, fault)
    res = _dry(capsys, workload)
    assert res["correct"] is False
    assert res["checks"]["gen_gap"]["value"] > \
        res["checks"]["gen_gap"]["limit"]


def test_a_decode_step_that_leaves_its_state_unchanged_is_not_correct(
        capsys, monkeypatch):
    """The eager CPU decode, each step on a copy of the cache; granite's
    cells take this fault on the card (``test_portbench_faults_card``):
    their random-weight greedy tokens do not depend on the context."""
    from repro_torch.serving import engine
    step = engine.decode_step

    def stale(cfg, params, token, pos, caches):
        logits, _ = step(cfg, params, token, pos, copy.deepcopy(caches))
        return logits, caches  # the cache never takes the new token
    monkeypatch.setattr(engine, "decode_step", stale)
    tiny = bench.tiny  # short prompts, long decodes: more stale context;
    # five invocations checked, as a card run checks many
    monkeypatch.setattr(bench, "tiny", lambda mix: dict(
        tiny(mix), new_tokens=24, max_len=64, check_tokens=480,
        prompt={"median": 8, "sigma": 0.1, "min": 8, "max": 8,
                "round_to": 8}))
    res = _dry(capsys, "olmoe-1b-7b.serve_steady", "2")
    assert res["correct"] is False


def test_an_invocation_that_fails_is_not_correct(capsys, monkeypatch):
    from repro_torch.serving import engine
    serve = engine.ServingEngine._serve
    calls = []

    def flaky(self, entry, tokens, max_new_tokens, extras):
        if max_new_tokens > 2:  # a window's invocation, not a warm-up
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("planted")
        return serve(self, entry, tokens, max_new_tokens, extras)
    monkeypatch.setattr(engine.ServingEngine, "_serve", flaky)
    res = _dry(capsys, "olmoe-1b-7b.serve_steady", "2")
    assert res["failed"] >= 1 and res["correct"] is False


def test_judge_compares_each_number_the_limits_name():
    limits = {"gen_gap": 1.0, "logit_err": 0.06}
    ok, checks = check.judge({"gen_gap": 0.0, "logit_err": 0.02,
                              "logit_err_med": 9.0}, 0, limits)
    assert ok and set(checks) == {"failed", "gen_gap", "logit_err"}
    assert not check.judge({"gen_gap": 0.0, "logit_err": 0.07}, 0,
                           limits)[0]
    assert not check.judge({"gen_gap": 0.0}, 1, limits)[0]
    assert not check.judge({}, 0, limits)[0]  # nothing was checked
