"""A decode step that leaves its state unchanged, planted in the graphed
decode on the card, makes ``correct`` false in every cell.

On the CPU the engine decodes eagerly and serves no logits, and with
random weights granite-8b's greedy token repeats the last one whatever
its context, so only the card's served logits (``logit_err``) can show
a stale cache there.  Run on the card with
``python -m pytest -q -m cuda portbench/tests``.
"""

import pytest

from portbench import bench, check

CELLS = ["granite-8b.fleet_zipf", "olmoe-1b-7b.serve_steady"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_stale_decode_cache_is_not_correct(card, cell, monkeypatch):
    from repro_torch.serving import graphs
    replay = graphs.DecodeGraph.__call__

    def stale(self, tok, pos):
        saved = [t.clone() for t in _leaves(self.caches)]
        out = replay(self, tok, pos)
        for t, s in zip(_leaves(self.caches), saved):
            t.copy_(s)  # the step's writes undone: its state unchanged
        return out
    args = bench.parse(["--workload", cell, "--seed", "2147483911",
                        "--seconds", "8"])
    c, run, system = bench.setup(args, 0.0)
    monkeypatch.setattr(graphs.DecodeGraph, "__call__", stale)
    bench.drive(system, run, 8.0, False)
    system.close()
    picked = check.sample(run.records, run.outputs, run.mix, args.seed)
    gaps = check.reference_gaps(run.cfg, picked, run.outputs, args.seed,
                                "cuda", last_logits=run.last_logits)
    correct, checks = check.judge(gaps, 0, c.limits)
    print(cell, checks)
    assert not correct
