"""The plain reference against the port's plain CPU path."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import bench
from portbench.reference import model as ref_model
from portbench.reference import weights as ref_weights


def _pair(arch, capacity=None):
    from repro_torch.configs import get_reduced
    from repro_torch.serving import ServingEngine
    cfg = json.loads((bench.ROOT / "portbench" / "configs"
                      / f"{arch}.json").read_text())
    cfg = {**cfg, **cfg["cpu_test"]}
    c = get_reduced(arch)
    if capacity is not None:  # the served capacity, so slots are dropped
        c = c.with_(moe=dataclasses.replace(c.moe,
                                            capacity_factor=capacity))
        cfg["moe"] = dict(cfg["moe"], capacity_factor=capacity)
    eng = ServingEngine(c, seed=2**31 + 17, batch_size=4, prefill_len=8,
                        max_len=40, device="cpu")
    eng.cold_start()
    return cfg, eng


CASES = [("granite-8b", None), ("olmoe-1b-7b", None), ("olmoe-1b-7b", 1.25)]


@pytest.mark.parametrize("arch,capacity", CASES)
def test_weights_are_the_programs_bit_for_bit(arch, capacity):
    cfg, eng = _pair(arch, capacity)
    mine = ref_weights.draw(cfg, 2**31 + 17, "cpu")

    def walk(a, b, path=""):
        assert a.keys() == b.keys(), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}{k}/")
            else:
                assert torch.equal(a[k], b[k]), path + k
    walk(eng._params, mine)


@pytest.mark.parametrize("arch,capacity", CASES)
def test_reference_logits_agree_with_the_served_tokens(arch, capacity):
    cfg, eng = _pair(arch, capacity)
    params = ref_weights.draw(cfg, 2**31 + 17, "cpu")
    rng = np.random.default_rng(5)
    S, new = 13, 6
    toks = rng.integers(0, cfg["vocab"], (4, S)).astype(np.int32)
    out, _ = eng.serve("generate", toks, max_new_tokens=new)
    full = torch.as_tensor(np.concatenate([toks, out[:, :-1]], 1)).long()
    ref = ref_model.logits(cfg, params, full, list(range(S - 1, S - 1 + new)),
                           prefill_len=S)
    assert torch.equal(ref.argmax(-1), torch.as_tensor(out).long())
    scored, _ = eng.serve("score", toks)
    ref = ref_model.logits(cfg, params, torch.as_tensor(toks).long(),
                           list(range(S)), prefill_len=S)
    assert torch.allclose(torch.as_tensor(scored), ref, rtol=1e-4,
                          atol=1e-4 * ref.abs().max().item())


def test_decode_groups_are_the_batch_at_each_position():
    groups = ref_model._route_groups(2, 5, 3, 4096)
    assert [g.tolist() for g in groups] == [[0, 1, 2, 5, 6, 7], [3, 8],
                                            [4, 9]]
    groups = ref_model._route_groups(2, 4, 4, 4)
    assert [g.tolist() for g in groups] == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_the_fp8_control_rounds_the_matmuls():
    x = torch.randn(16, 64, generator=torch.Generator().manual_seed(0))
    y = ref_model._fp8(x, -1)
    rel = ((y - x).abs() / x.abs().clamp_min(1e-3)).median()
    assert 1e-3 < rel < 0.07
