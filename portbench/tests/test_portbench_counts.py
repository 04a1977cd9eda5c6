"""counts.py against hand counts on a reduced configuration."""

import json

import pytest

from portbench import bench
from portbench.metrics import counts

CFG = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
       "head_dim": 2, "d_ff": 16, "vocab": 10}


def test_body_and_head_params_by_hand():
    # q 8x8, k and v 8x4 each, o 8x8, gated MLP 8x32 + 16x8, two layers
    assert counts.body_params(CFG) == 2 * (64 + 32 + 32 + 64 + 256 + 128)
    assert counts.head_params(CFG) == 80


def test_moe_body_params_count_the_routed_experts_only():
    moe = dict(CFG, moe={"n_experts": 4, "top_k": 2, "d_expert_ff": 3})
    attn = 64 + 32 + 32 + 64
    assert counts.body_params(moe) == 2 * (attn + 8 * 4 + 2 * 3 * 8 * 3)


def test_served_flops_by_hand():
    body, head = counts.body_params(CFG), counts.head_params(CFG)
    B, S, new = 3, 5, 3
    attn = lambda pairs: 4 * 2 * 4 * B * pairs * 2  # noqa: E731
    want = 2 * body * B * S + attn(15) + 2 * head * B
    want += 2 * (body + head) * B + attn(6)  # decode at position 5
    want += 2 * (body + head) * B + attn(7)  # and at 6
    assert counts.served_flops(CFG, B, "generate", S, new) == want
    assert counts.served_flops(CFG, B, "score", S, 0) == \
        2 * body * B * S + attn(15) + 2 * head * B * S


def test_kernel_calls_by_hand():
    f, b = counts.flash_call(CFG, 3, 5)
    assert f == 4 * 2 * 4 * 3 * 15
    assert b == 2 * 3 * 5 * 2 * (2 * 4 + 2 * 2)
    f, b = counts.decode_call(CFG, 3, 7)
    assert f == 4 * 2 * 4 * 3 * 7
    assert b == 2 * 3 * 2 * (2 * 4 + 2 * 2 * 7)
    assert counts.least_s(989e12, 1) == pytest.approx(1.0)
    assert counts.least_s(1, 3.35e12) == pytest.approx(1.0)


def test_kernel_work_counts_served_calls_and_warmups():
    recs = [{"ok": True, "entry": "generate", "prompt_len": 5,
             "new_tokens": 3, "built": ["compile.generate",
                                        "compile.score"]},
            {"ok": True, "entry": "score", "prompt_len": 4,
             "new_tokens": 0, "built": []},
            {"ok": False, "entry": "generate", "prompt_len": 9,
             "new_tokens": 3, "built": []}]
    fl_s, fl_n, dec_s, dec_n = counts.kernel_work(CFG, 3, recs, 6)
    L = CFG["n_layers"]
    # warm-ups: two prefills at 6, one decode over 1 slot; served: the
    # prefills at 5 and 4, decodes over 6 and 7 slots
    assert fl_n == 4 * L and dec_n == 3 * L
    want = L * sum(counts.least_s(*counts.flash_call(CFG, 3, s))
                   for s in (6, 6, 5, 4))
    assert fl_s == pytest.approx(want)
    want = L * sum(counts.least_s(*counts.decode_call(CFG, 3, n))
                   for n in (1, 6, 7))
    assert dec_s == pytest.approx(want)


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
def test_body_params_match_the_ports_parameter_count(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = json.loads((bench.ROOT / "portbench" / "configs"
                      / f"{arch}.json").read_text())
    c = get_config(arch)
    norms = c.n_layers * (2 + 2 * c.qk_norm * c.head_dim / c.d_model) \
        * c.d_model + c.d_model
    embed = c.vocab * c.d_model * (1 if c.tie_embeddings else 2)
    total = M.param_count(c) - norms - embed
    if c.moe:  # every expert, where a token passes through top_k
        e = c.moe
        total -= c.n_layers * 3 * c.d_model * e.d_expert_ff * (
            e.n_experts - e.top_k)
    assert counts.body_params(cfg) == total
