"""The MoE layer's expert-sparse decode path on the CPU: which path a
call takes, and the kernels' plain version against ``moe_apply``'s
batched product (the card's kernels are held to both in
``tests/test_torch_cuda.py``)."""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import moe_decode as MD  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


def _card_tensor(requires_grad=False):
    """What ``takes_kernel`` reads of a CUDA tensor, without a card."""
    return types.SimpleNamespace(device=torch.device("cuda", 0),
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("arch,n,want", [
    ("olmoe-1b-7b", 4, 1),              # decode at batch 4: cap 1
    ("olmoe-1b-7b", 16, 2),             # batch 16: cap 2
    ("olmoe-1b-7b", 4 * 1024, 640),     # prefill of 4 x 1024
    ("granite-moe-1b-a400m", 4, 1),
    ("granite-moe-1b-a400m", 16, 5),
])
def test_rows_per_expert_and_the_path_they_take(arch, n, want):
    cfg = get_config(arch)
    assert L.moe_rows(cfg, n) == want
    x = _card_tensor()
    assert MD.takes_kernel(want, x, x, x) == (want <= MD.R_MAX)


def test_batch_16_decode_takes_the_kernels_and_prefill_does_not():
    cfg, x = get_config("olmoe-1b-7b"), _card_tensor()
    assert MD.takes_kernel(L.moe_rows(cfg, 16), x, x, x)  # cap 2
    assert not MD.takes_kernel(L.moe_rows(cfg, 4 * 512), x, x, x)


def test_the_path_needs_a_card_tensor():
    x = torch.zeros(4, 8)
    assert not MD.takes_kernel(1, x, x, x)
    meta = torch.zeros(4, 8, device="meta")
    assert not MD.takes_kernel(1, meta, meta, meta)


def test_the_path_is_not_taken_where_a_gradient_is_needed():
    x, w = _card_tensor(), _card_tensor(requires_grad=True)
    assert not MD.takes_kernel(1, x, w, x)
    with torch.no_grad():
        assert MD.takes_kernel(1, x, w, x)
    assert MD.takes_kernel(1, x, x, x)


def test_the_path_is_not_taken_on_a_dtensor(monkeypatch):
    x = _card_tensor()
    sharded = _card_tensor()
    monkeypatch.setattr(_build, "is_dtensor", lambda t: t is sharded)
    assert not MD.takes_kernel(1, sharded, x, x)
    assert not MD.takes_kernel(1, x, sharded, x)
    assert MD.takes_kernel(1, x, x, x)


def _olmoe(capacity_factor):
    cfg = get_reduced("olmoe-1b-7b")
    return cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 2, 4, 16])
def test_plain_version_matches_moe_apply_with_drops(B, dtype):
    """Reduced olmoe at capacity 1.25 (its 8 experts top-2 drop slots at
    every decode batch above 1 here) and decode shapes: the plain per-expert
    version equals the batched path, and a CPU call of ``moe_decode``
    runs it."""
    cfg = _olmoe(1.25)
    g = torch.Generator().manual_seed(B + 1)
    p = {k: (torch.randn(s.shape, generator=g) / s.shape[-2] ** 0.5)
         .to(dtype) for k, s in L.moe_template(cfg).items()}
    x = torch.randn((B, 1, cfg.d_model), generator=g).to(dtype)
    y, _ = L.moe_apply(p, cfg, x)
    gs = min(cfg.moe_group, B)
    _, top_p, top_e, pos, cap, _ = L.moe_route(
        p, cfg, x.reshape(B // gs, gs, cfg.d_model))
    if B > 1:
        assert (pos >= cap).any()  # some slot dropped
    got = MD.moe_decode_plain(x[:, 0], top_e, pos, top_p, p["wi"], p["wo"],
                              gs=gs, cap=cap)
    assert got.dtype == dtype
    torch.testing.assert_close(got, y[:, 0])
    n0 = MD.moe_decode.launches
    torch.testing.assert_close(
        MD.moe_decode(x[:, 0], top_e, pos, top_p, p["wi"], p["wo"], gs=gs,
                      cap=cap), got, rtol=0, atol=0)
    assert MD.moe_decode.launches == n0  # the plain version launches none


def test_plain_version_skips_a_dropped_slot():
    """A dropped slot adds nothing even where its expert's output would
    not be finite: the slot is skipped, not weighted by 0."""
    cfg = _olmoe(1.25)
    g = torch.Generator().manual_seed(3)
    p = {k: torch.randn(s.shape, generator=g) / s.shape[-2] ** 0.5
         for k, s in L.moe_template(cfg).items()}
    x = torch.randn((4, cfg.d_model), generator=g)
    _, top_p, top_e, pos, cap, _ = L.moe_route(p, cfg, x.reshape(1, 4, -1))
    dropped = pos >= cap
    assert dropped.any()
    want = MD.moe_decode_plain(x, top_e, pos, top_p, p["wi"], p["wo"],
                               gs=4, cap=cap)
    kept = set(top_e[~dropped].tolist())
    idle = [e for e in range(cfg.moe.n_experts) if e not in kept]
    assert idle
    for e in idle:  # an expert no kept slot names is never read
        p["wi"][e] = float("nan")
        p["wo"][e] = float("nan")
    got = MD.moe_decode_plain(x, top_e, pos, top_p, p["wi"], p["wo"],
                              gs=4, cap=cap)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tiles_feed_every_sm_at_decode():
    """olmoe at batch 4: 64-column up tiles and 128-column down tiles
    (32 reachable experts x 16 tiles); granite-moe: half as wide."""
    assert MD.tiles(64, 32, 1024, 2048, 8) == (64, 128)
    assert MD.tiles(32, 32, 512, 1024, 8) == (32, 64)
    tn_up, tn_down = MD.tiles(8, 2, 32, 64, 4)  # reduced: one vector
    assert (tn_up, tn_down) == (4, 4)


def test_a_cpu_engine_sets_no_expert_counts_on_its_serve_span():
    """The counts come from the kernels' device counter: a CPU engine,
    whose MoE runs the batched product, sets neither attribute."""
    import numpy as np

    from repro_torch.obs import tracing
    from repro_torch.serving import ServingEngine
    cfg = _olmoe(1.25)
    tr = tracing.get_tracer()
    tr.clear()
    tracing.configure_tracing(enabled=True)
    try:
        eng = ServingEngine(cfg, seed=0, batch_size=2, prefill_len=8,
                            max_len=16, device="cpu")
        eng.cold_start()
        eng.serve("generate", np.zeros((2, 8), dtype=np.int32),
                  max_new_tokens=3)
        (serve,) = [s for s in tr.snapshot() if s.name == "serve"]
        assert serve.attrs["decode_steps"] == 2
        assert "moe_experts_read" not in serve.attrs
        assert "moe_expert_slots" not in serve.attrs
    finally:
        tracing.configure_tracing(enabled=False)
        tr.clear()
