"""PyTorch port on the card: each CUDA kernel against its plain version,
and the reduced model's CUDA path against its CPU path.

Marked ``cuda``: skipped (with the reason) where no CUDA card is
present.  Imports neither JAX nor ``repro``, so it runs where only the
port's requirements are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain,
)
from repro_torch.kernels import moe_decode as MD  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan, rglru_scan_plain,
)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
# decode's outputs, and those of flash with no mask, are averages over
# many keys, |o| ~ sqrt(e / n_keys) (0.036 at 2048 slots, 0.043 at 1500
# frames), so their bf16 limit is held to the output's scale: a split of
# the combine read stale or left out, or a key tile lost, moves o by ~0.01
DECODE_TOL = {torch.float32: TOL[torch.float32],
              torch.bfloat16: dict(rtol=2e-2, atol=5e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,Sq,Skv,hd,causal,window,cap,layout", [
    (2, 8, 2, 130, 130, 128, True, None, None, "bhsd"),
    (1, 4, 1, 40, 40, 32, True, 16, None, "bhsd"),
    (1, 2, 2, 33, 33, 16, True, None, 30.0, "bhsd"),
    (1, 2, 2, 16, 80, 64, False, None, None, "bhsd"),
    (1, 10, 1, 100, 100, 256, True, 48, None, "bhsd"),  # recurrentgemma
    # bf16 here runs the wgmma kernel: ragged against its 64-key (hd 256)
    # and 128-key (hd 128) tiles, a window straddling tiles, gemma2's
    # softcap, bidirectional Sq != Skv, and the model's strided views
    (1, 4, 2, 200, 200, 128, True, None, None, "bhsd"),
    (1, 2, 1, 130, 130, 256, True, None, None, "bhsd"),
    (1, 2, 1, 200, 200, 256, True, None, None, "bhsd"),
    (1, 10, 1, 200, 200, 256, True, 48, None, "bhsd"),
    (1, 2, 1, 130, 130, 256, True, None, 50.0, "bhsd"),
    (1, 4, 2, 16, 200, 128, False, None, None, "bhsd"),
    (1, 2, 1, 16, 200, 256, False, None, None, "bhsd"),
    (2, 8, 2, 200, 200, 128, True, None, None, "model"),
    (2, 10, 1, 130, 130, 256, True, 48, None, "model"),
    # granite-moe: hd 64, G 2, its prefill shape and a ragged one
    (4, 16, 8, 512, 512, 64, True, None, None, "model"),
    (1, 4, 2, 130, 130, 64, True, None, None, "bhsd"),
    # whisper: hd 64, G 1 -- the encoder over 1500 frames with no mask
    # (12 q tiles, the last of 92 rows), the decoder's causal prefill,
    # cross attention (Sq 224, Skv 1500) and a small ragged case;
    # pixtral: hd 128, G 4, its 768-token vision prefill
    (4, 20, 20, 1500, 1500, 64, False, None, None, "model"),
    (4, 20, 20, 224, 224, 64, True, None, None, "model"),
    (4, 20, 20, 224, 1500, 64, False, None, None, "bhsd"),
    (2, 4, 4, 150, 70, 64, False, None, None, "bhsd"),
    (4, 32, 8, 768, 768, 128, True, None, None, "model"),
    # gemma2: hd 256, G 2, softcap 50 with and without a window (the
    # window's edge straddling 64-key tiles); gemma3: hd 128, G 2, a
    # window; both at a window of 1024 over 1100 keys
    (1, 4, 2, 200, 200, 256, True, 48, 50.0, "bhsd"),
    (2, 4, 2, 130, 130, 256, True, None, 50.0, "model"),
    (1, 4, 2, 1100, 1100, 256, True, 1024, 50.0, "model"),
    (2, 4, 2, 300, 300, 128, True, 64, None, "model"),
    (1, 4, 2, 1100, 1100, 128, True, 1024, None, "model"),
    # qwen2.5-32b: hd 128, G 5 (odd, above 1); olmoe-1b-7b: hd 128, G 1;
    # small, ragged, and at their 512-token prefill
    (1, 10, 2, 40, 40, 128, True, None, None, "bhsd"),
    (1, 10, 2, 130, 130, 128, True, None, None, "model"),
    (4, 40, 8, 512, 512, 128, True, None, None, "model"),
    (1, 4, 4, 24, 24, 128, True, None, None, "bhsd"),
    (4, 16, 16, 512, 512, 128, True, None, None, "model"),
])
def test_flash_kernel_matches_plain(cuda, B, H, K, Sq, Skv, hd, causal,
                                    window, cap, layout, dtype):
    rng = np.random.default_rng(Sq + hd)
    if layout == "model":  # (B, S, K, G, hd) activations, transposed views
        assert Sq == Skv
        q = _rand(rng, (B, Sq, K, H // K, hd), dtype, cuda).reshape(
            B, Sq, H, hd).transpose(1, 2)
        k = _rand(rng, (B, Skv, K, hd), dtype, cuda).transpose(1, 2)
        v = _rand(rng, (B, Skv, K, hd), dtype, cuda).transpose(1, 2)
    else:
        q = _rand(rng, (B, H, Sq, hd), dtype, cuda)
        k = _rand(rng, (B, K, Skv, hd), dtype, cuda)
        v = _rand(rng, (B, K, Skv, hd), dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=cap)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    # with no mask every row averages over all Skv keys
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v, **kw).float(), **(TOL if causal else DECODE_TOL)[dtype])


@pytest.mark.parametrize("which,hd", [("k", 16), ("q", 128)])
def test_flash_kernel_rejects_misaligned_rows(cuda, which, hd):
    """k and v rows must be 16-byte aligned for both kernels; q rows too
    for the wgmma kernel (bf16 at hd 128), which loads q with TMA."""
    rng = np.random.default_rng(3)
    good = _rand(rng, (1, 2, 8, hd), torch.bfloat16, cuda)
    bad = _rand(rng, (1, 2, 8, hd + 4), torch.bfloat16, cuda)[..., 2:hd + 2]
    q, k = (good, bad) if which == "k" else (bad, good)
    n0 = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, k)
    assert flash_attention.launches == n0


def _decode_inputs(rng, B, K, G, S, hd, dtype, device, ring):
    q = _rand(rng, (B, K, G, hd), dtype, device)
    k = _rand(rng, (B, K, S, hd), dtype, device)
    v = _rand(rng, (B, K, S, hd), dtype, device)
    base = torch.arange(S, device=device)
    if ring:  # slot i holds the newest position p <= cur with p % S == i
        cur = S + 7
        kv_pos = torch.where(base <= cur % S, base + (cur // S) * S,
                             base + (cur // S - 1) * S)
        q_pos = torch.full((B,), cur, dtype=torch.int32, device=device)
    else:
        n_valid = max(1, S - 7)
        kv_pos = torch.where(base < n_valid, base, -1)
        q_pos = torch.full((B,), n_valid - 1, dtype=torch.int32,
                           device=device)
    kv_pos = kv_pos.to(torch.int32).expand(B, S).contiguous()
    return q, k, v, q_pos, kv_pos


@pytest.mark.parametrize("which,dtype,hd", [
    ("k", torch.float32, 16), ("v", torch.bfloat16, 128),
    ("q", torch.bfloat16, 128)])
def test_decode_kernel_rejects_misaligned_rows(cuda, which, dtype, hd):
    """k and v rows must be 16-byte aligned for both kernels; q rows too
    for the tensor-core kernel (bf16 at hd 128), which copies q with
    cp.async."""
    rng = np.random.default_rng(4)
    args = dict(zip("qkv", (
        _rand(rng, (1, 2, 4 if n == "q" else 40, hd), dtype, cuda)
        for n in "qkv")))
    bad = _rand(rng, (1, 2, 4 if which == "q" else 40, hd + 4), dtype,
                cuda)[..., 2:hd + 2]
    args[which] = bad
    q_pos = torch.full((1,), 39, dtype=torch.int32, device=cuda)
    kv_pos = torch.arange(40, dtype=torch.int32, device=cuda)[None]
    n0 = decode_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention(args["q"], args["k"], args["v"], q_pos, kv_pos)
    assert decode_attention.launches == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,S,hd,window,cap,ring", [
    (4, 8, 4, 640, 128, None, None, False),
    (2, 2, 1, 40, 16, 16, None, False),
    (1, 2, 2, 33, 32, None, 30.0, False),
    (2, 1, 10, 96, 256, 96, None, True),  # recurrentgemma: wrapped ring
    # the bf16 cases below run the tensor-core kernel: S below one 32-slot
    # tile (one split, o written directly), S ragged against the tile and
    # the split, G = 1 / 4 / 10 / 16, hd 64 / 128 / 256, wrapped rings
    # with window and softcap, and both main paths' shapes
    (1, 2, 4, 20, 128, None, None, False),
    (2, 2, 4, 77, 128, None, None, False),
    (1, 1, 1, 300, 64, None, None, False),
    (2, 2, 4, 150, 64, 40, 30.0, True),
    (1, 1, 16, 200, 128, None, None, False),
    (2, 1, 10, 333, 256, 64, 50.0, True),
    (1, 4, 4, 1000, 128, 128, 30.0, True),
    (4, 1, 10, 2048, 256, 2048, None, True),
    # granite-moe: hd 64, G 2, its decode shape and a ragged one
    (4, 8, 2, 640, 64, None, None, False),
    (2, 2, 2, 77, 64, None, None, False),
    # whisper's self decode: hd 64, G 1 over its 448-slot cache
    (4, 20, 1, 448, 64, None, None, False),
    # gemma2: hd 256, G 2, softcap 50 over a wrapped ring with its window
    # and over a position-indexed cache, small and at its 4096-slot ring
    # and 4624-slot global cache; gemma3: hd 128, G 2, a wrapped ring,
    # small and at its 1024-slot ring
    (2, 2, 2, 150, 256, 64, 50.0, True),
    (2, 2, 2, 333, 256, None, 50.0, False),
    (4, 8, 2, 4096, 256, 4096, 50.0, True),
    (4, 8, 2, 4624, 256, None, 50.0, False),
    (2, 2, 2, 150, 128, 64, None, True),
    (4, 16, 2, 1024, 128, 1024, None, True),
    # qwen2.5-32b: hd 128, G 5; olmoe-1b-7b: hd 128, G 1; small and at
    # their 640-slot caches
    (1, 2, 5, 40, 128, None, None, False),
    (2, 2, 5, 77, 128, None, None, False),
    (4, 8, 5, 640, 128, None, None, False),
    (2, 4, 1, 33, 128, None, None, False),
    (4, 16, 1, 640, 128, None, None, False),
])
def test_decode_kernel_matches_plain(cuda, B, K, G, S, hd, window, cap,
                                     ring, dtype):
    rng = np.random.default_rng(S + hd)
    args = _decode_inputs(rng, B, K, G, S, hd, dtype, cuda, ring)
    kw = dict(window=window, softcap=cap)
    n0 = decode_attention.launches
    got = decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    torch.testing.assert_close(got.float(), decode_attention_plain(
        *args, **kw).float(), **DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,S,hd,q_pos", [
    (4, 20, 1, 1500, 64, 224),  # whisper's cross decode: 46 tiles and 28
    (2, 2, 1, 77, 64, 3),       # slots, 80 (b, kv-head) pairs
    (1, 3, 1, 45, 16, 0),
    (2, 2, 4, 100, 128, 5),
])
def test_decode_kernel_all_valid_cache(cuda, B, K, G, S, hd, q_pos, dtype):
    """Cross-attention decode: every slot of a cache whose length is not
    a multiple of the 32-slot tile is kept (slot positions 0, the
    decode position below the cache length)."""
    rng = np.random.default_rng(S + hd + 1)
    q = _rand(rng, (B, K, G, hd), dtype, cuda)
    k = _rand(rng, (B, S, K, hd), dtype, cuda).transpose(1, 2)
    v = _rand(rng, (B, S, K, hd), dtype, cuda).transpose(1, 2)
    qp = torch.full((B,), q_pos, dtype=torch.int32, device=cuda)
    kv_pos = torch.zeros((B, S), dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, qp, kv_pos)
    torch.cuda.synchronize()
    want = decode_attention_plain(q, k, v, qp, kv_pos)
    torch.testing.assert_close(got.float(), want.float(),
                               **DECODE_TOL[dtype])
    # the plain version keeps every slot: it is softmax attention over all
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float()) * hd ** -0.5
    full = torch.einsum("bkgs,bksd->bkgd", s.softmax(-1), v.float())
    torch.testing.assert_close(want.float(), full, **DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 16),
                                      (torch.bfloat16, 16),
                                      (torch.bfloat16, 128),
                                      (torch.bfloat16, 256)])
@pytest.mark.parametrize("S", [20, 100])
def test_decode_kernel_row_without_valid_slot(cuda, dtype, hd, S):
    """Every slot empty: the oracle's answer, the mean of v over the S
    slots, with one split (S 20) and through the folded combine (S 100)."""
    rng = np.random.default_rng(S)
    q = _rand(rng, (1, 1, 4, hd), dtype, cuda)
    k = _rand(rng, (1, 1, S, hd), dtype, cuda)
    v = _rand(rng, (1, 1, S, hd), dtype, cuda)
    q_pos = torch.zeros((1,), dtype=torch.int32, device=cuda)
    kv_pos = torch.full((1, S), -1, dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, q_pos, kv_pos)
    want = v.float().mean(dim=2, keepdim=True).expand(1, 1, 4, hd)
    torch.testing.assert_close(got.float(), want.to(dtype).float(),
                               **DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128),
                                      (torch.bfloat16, 128),
                                      (torch.bfloat16, 256)])
def test_decode_kernel_back_to_back_calls(cuda, dtype, hd):
    """Calls in a row, without a sync between them, reuse the combine's
    ticket counters and partials: each call's answer must be its own."""
    rng = np.random.default_rng(hd)
    calls = [_decode_inputs(rng, 2, 2, 4, S, hd, dtype, cuda, ring)
             for S, ring in ((300, False), (300, True), (700, False))]
    got = [decode_attention(*args, window=64) for args in calls]
    torch.cuda.synchronize()
    for args, o in zip(calls, got):
        torch.testing.assert_close(o.float(), decode_attention_plain(
            *args, window=64).float(), **DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128),
                                      (torch.bfloat16, 256)])
def test_decode_kernel_calls_on_two_streams(cuda, dtype, hd):
    """Calls in flight on two streams at once each use their stream's
    ticket counters and partials: both answers are right."""
    rng = np.random.default_rng(hd + 1)
    calls = [_decode_inputs(rng, 4, 2, 4, 640, hd, dtype, cuda, ring)
             for ring in (False, True)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = []
    for args, st in zip(calls, streams):
        with torch.cuda.stream(st):
            got.append([decode_attention(*args) for _ in range(8)])
    torch.cuda.synchronize()
    for args, outs in zip(calls, got):
        want = decode_attention_plain(*args).float()
        for o in outs:
            torch.testing.assert_close(o.float(), want, **DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 128, "decode_mma"), (torch.bfloat16, 256, "decode_mma"),
    (torch.float32, 128, "decode_simt")])
def test_decode_kernel_one_launch_per_call(cuda, dtype, hd, kernel):
    """The combine is folded into the one launch: the profiler sees one
    kernel a call, of the instance ``instance()`` names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(9)
    args = _decode_inputs(rng, 4, 2, 4, 640, hd, dtype, cuda, False)
    decode_attention(*args)  # scratch allocated outside the trace
    torch.cuda.synchronize()
    # after an earlier profiler session in the process, a session may
    # record no device event at all (seen on the H100): such a session
    # says nothing about the launch, so up to two more are taken; the
    # first that records anything must hold exactly the one kernel
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            decode_attention(*args)
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA]
        if names:
            break
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R,with_h0", [
    (2, 64, 128, False),
    (1, 40, 130, True),   # ragged channel dim
    (2, 17, 64, True),    # ragged time dim
    (4, 300, 2560, True),  # recurrentgemma's width
    (2, 1, 64, True),     # one step
    (1, 37, 2560, False),  # S not a multiple of the 32-step buffer
    (2, 50, 33, True),    # R not a multiple of the 64-channel block
    (4, 2048, 2560, False),  # recurrentgemma's prefill
])
def test_rglru_kernel_matches_plain(cuda, B, S, R, with_h0, dtype):
    rng = np.random.default_rng(S + R)
    a = torch.sigmoid(_rand(rng, (B, S, R), torch.float32, cuda)).to(dtype)
    b = _rand(rng, (B, S, R), dtype, cuda)
    h0 = _rand(rng, (B, R), dtype, cuda) if with_h0 else None
    n0 = rglru_scan.launches
    got = rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert rglru_scan.launches == n0 + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), rglru_scan_plain(
        a, b, h0).float(), **TOL[dtype])


@pytest.mark.parametrize("h0_dtype", [torch.bfloat16, torch.float16])
def test_rglru_kernel_h0_any_dtype(cuda, h0_dtype):
    """h0 of another dtype than a is read as fp32, as the plain version
    reads it."""
    rng = np.random.default_rng(21)
    a = torch.sigmoid(_rand(rng, (2, 40, 96), torch.float32, cuda))
    b = _rand(rng, (2, 40, 96), torch.float32, cuda)
    h0 = _rand(rng, (2, 96), h0_dtype, cuda)
    got = rglru_scan(a, b, h0)
    torch.testing.assert_close(got, rglru_scan_plain(a, b, h0),
                               **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_unaligned_start(cuda, dtype):
    """a and b starting one element past a 16-byte boundary (a contiguous
    slice of a larger buffer): the kernel reads elements, so any
    alignment is taken."""
    rng = np.random.default_rng(22)
    B, S, R = 2, 45, 70
    n = B * S * R
    a = torch.sigmoid(_rand(rng, (n + 1,), torch.float32, cuda)).to(
        dtype)[1:].view(B, S, R)
    b = _rand(rng, (n + 3,), dtype, cuda)[3:].view(B, S, R)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    got = rglru_scan(a, b)
    torch.testing.assert_close(got.float(), rglru_scan_plain(a, b).float(),
                               **TOL[dtype])


# the int8 KV cache on gemma2-9b, beside its bf16 one
INT8 = pytest.param("gemma2-9b", 20, {"kv_quant": "int8"},
                    id="gemma2-9b-int8")
# reduced olmoe at its published capacity 1.25: one row per expert at a
# decode batch of 2, so its decode step runs the expert-sparse kernels,
# with drops
SPARSE_MOE = {"moe": dataclasses.replace(get_reduced("olmoe-1b-7b").moe,
                                          capacity_factor=1.25)}
OLMOE_SPARSE = pytest.param("olmoe-1b-7b", 6, SPARSE_MOE,
                            id="olmoe-1b-7b-cap1.25")


@pytest.mark.parametrize("arch,n_dec,cfg_kw", [("granite-8b", 5, {}),
                                               ("qwen2.5-32b", 5, {}),
                                               ("recurrentgemma-2b", 20, {}),
                                               ("granite-moe-1b-a400m", 5,
                                                {}),
                                               ("olmoe-1b-7b", 5, {}),
                                               ("whisper-large-v3", 5, {}),
                                               ("pixtral-12b", 5, {}),
                                               ("gemma2-9b", 20, {}),
                                               ("gemma3-27b", 20, {}),
                                               ("xlstm-350m", 5, {}), INT8,
                                               OLMOE_SPARSE])
def test_reduced_model_cuda_matches_cpu(cuda, arch, n_dec, cfg_kw):
    """recurrentgemma, gemma2 and gemma3 decode past their window of 16,
    so the ring wraps; whisper runs its encoder over random frames and
    decodes through the cross-attention cache, pixtral prefills behind
    random patch embeddings; xlstm runs its mLSTM / sLSTM loops on the
    card; the int8 KV cache's codes may differ by one step where a value
    lies on a rounding boundary."""
    cfg = get_reduced(arch).with_(**cfg_kw)
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}
    gparams = to(params)
    B, T0, vt = 2, 8, cfg.vision_tokens
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, T0 + n_dec)).astype(np.int32))
    ex = {}
    if cfg.vision_tokens:
        ex["patch_embeds"] = (B, vt, cfg.d_model)
    if cfg.encoder_layers:
        ex["enc_frames"] = (B, cfg.encoder_seq, cfg.d_model)
    ex = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for k, s in ex.items()}
    lc, cc, ac = M.prefill(cfg, params, toks[:, :T0],
                           cache_len=vt + T0 + n_dec, **ex)
    lg, cg, ag = M.prefill(cfg, gparams, toks[:, :T0].to(cuda),
                           cache_len=vt + T0 + n_dec,
                           **{k: v.to(cuda) for k, v in ex.items()})
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)
    assert ag.keys() == ac.keys()
    for k in ac:  # MoE: router load and loss
        torch.testing.assert_close(ag[k].cpu(), ac[k], rtol=1e-5, atol=1e-5)
    for i in range(n_dec):
        pos = torch.full((B,), vt + T0 + i, dtype=torch.int32)
        tok = toks[:, T0 + i:T0 + i + 1]
        lc, cc = M.decode_step(cfg, params, tok, pos, cc)
        lg, cg = M.decode_step(cfg, gparams, tok.to(cuda), pos.to(cuda), cg)
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tree[k]
    want = dict(leaves(cc))
    for name, got in leaves(cg):
        if got.dtype == torch.int8:
            assert want[name].dtype == torch.int8, name
            diff = got.cpu().int() - want[name].int()
            assert diff.abs().max().item() <= 1, name
            continue
        torch.testing.assert_close(got.cpu(), want[name], rtol=2e-3,
                                   atol=2e-3, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,group", [(2, 16, 8), (4, 1, None),
                                       (4, 512, None)])
def test_moe_apply_cuda_matches_cpu(cuda, B, S, group, dtype):
    """granite-moe's MoE layer at full width (d_model 1024, 32 experts,
    top-8, d_ff 512) with capacity 1.25: the same routing (experts and
    queue places) on the card as on the CPU, and the output within the
    kernel tolerances (the bf16 card path takes the fp32-output bmm)."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-moe-1b-a400m").with_(
        dtype="float32" if dtype == torch.float32 else "bfloat16")
    rng = np.random.default_rng(B * S)
    p = {k: (_rand(rng, s.shape, torch.float32, "cpu") / s.shape[-2] ** 0.5)
         .to(dtype) for k, s in L.moe_template(cfg).items()}
    x = _rand(rng, (B, S, cfg.d_model), dtype, "cpu")
    gp = {k: v.to(cuda) for k, v in p.items()}
    gs = min(group or cfg.moe_group, B * S)
    want = L.moe_route(p, cfg, x.reshape(-1, gs, cfg.d_model))
    got = L.moe_route(gp, cfg, x.to(cuda).reshape(-1, gs, cfg.d_model))
    assert torch.equal(got[2].cpu(), want[2])  # top_e
    assert torch.equal(got[3].cpu(), want[3])  # queue places
    yc, ac = L.moe_apply(p, cfg, x, group_size=group)
    yg, ag = L.moe_apply(gp, cfg, x.to(cuda), group_size=group)
    assert yg.dtype == dtype
    torch.testing.assert_close(yg.cpu().float(), yc.float(), **TOL[dtype])
    torch.testing.assert_close(ag["expert_load"].cpu(), ac["expert_load"])


# ---------------------------------------------------------- moe_decode
def _moe_layer(cuda, arch, dtype, B, seed):
    """Full-width random MoE weights of ``arch`` (normal / sqrt(fan-in))
    and B decode rows, drawn on the card, with their routing."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).with_(
        dtype="float32" if dtype == torch.float32 else "bfloat16")
    gen = torch.Generator(cuda).manual_seed(seed)
    p = {k: (torch.randn(s.shape, generator=gen, device=cuda)
             / s.shape[-2] ** 0.5).to(dtype)
         for k, s in L.moe_template(cfg).items()}
    x = torch.randn((B, cfg.d_model), generator=gen, device=cuda).to(dtype)
    gs = min(cfg.moe_group, B)
    _, top_p, top_e, pos, cap, _ = L.moe_route(
        p, cfg, x.reshape(B // gs, gs, cfg.d_model))
    return cfg, p, x, (top_e, pos, top_p), gs, cap


def _both_paths(p, x, route, gs, cap):
    got = MD.moe_decode(x, *route, p["wi"], p["wo"], gs=gs, cap=cap)
    want = L.moe_batched(p, x, *route, gs=gs, cap=cap)
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-1b-a400m"])
def test_moe_decode_matches_batched_path(cuda, arch, B, dtype):
    """The expert-sparse kernels against the batched product on the same
    routing, at full width (olmoe: rows per expert 1 and 2; granite-moe:
    1 and 5), and moe_apply taking the kernels where its rows allow."""
    cfg, p, x, route, gs, cap = _moe_layer(cuda, arch, dtype, B, B)
    got, want = _both_paths(p, x, route, gs, cap)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    plain = MD.moe_decode_plain(x, *route, p["wi"], p["wo"], gs=gs,
                                cap=cap)
    torch.testing.assert_close(got.float(), plain.float(), **TOL[dtype])
    n0 = MD.moe_decode.launches
    with torch.no_grad():
        y, _ = L.moe_apply(p, cfg, x[:, None])
    rows = L.moe_rows(cfg, B)
    assert MD.moe_decode.launches - n0 == \
        (MD.LAUNCHES if rows <= MD.R_MAX else 0)
    torch.testing.assert_close(y[:, 0].float(), got.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_decode_rigged_router_skips_dropped_slots(cuda, dtype,
                                                      monkeypatch):
    """Every token routed to experts 0..7 (olmoe, B 16: 2 of 16 slots
    kept in each), the scratch filled with NaN first: a dropped slot and
    an expert with no kept row (63) are skipped, never multiplied by 0,
    so the output is finite, equal to the batched path's, and 0 for a
    token whose every slot was dropped."""
    cfg, p, x, _, gs, cap = _moe_layer(cuda, "olmoe-1b-7b", dtype, 16, 5)
    D, E = cfg.d_model, cfg.moe.n_experts
    router = torch.randn(p["router"].shape, device=cuda) * 1e-3
    router[0, :8] = torch.arange(8, 0, -1, device=cuda, dtype=torch.float32)
    p["router"] = router.to(dtype)
    x = x.clone()
    x[:, 0] = 10.0
    _, top_p, top_e, pos, cap, _ = L.moe_route(p, cfg, x.reshape(1, 16, D))
    assert torch.equal(top_e.reshape(16, 8).sort(-1).values.cpu(),
                       torch.arange(8).expand(16, 8))
    keep = (pos < cap).reshape(16, 8)
    assert int(keep.sum()) == 8 * cap < 16 * 8
    route = (top_e, pos, top_p)

    def nan_scratch(E_, R, Fe, D_, dt, device):
        return (torch.full((E_, R, Fe), float("nan"), dtype=dt,
                           device=device),
                torch.full((E_, R, D_), float("nan"), device=device))
    monkeypatch.setattr(MD, "_scratch", nan_scratch)
    got, want = _both_paths(p, x, route, gs, cap)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    none_kept = ~keep.any(-1)
    assert none_kept.any()
    assert (got[none_kept] == 0).all()
    assert E - 1 not in top_e[pos < cap].tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_decode_two_calls_bitwise_equal(cuda, dtype):
    _, p, x, route, gs, cap = _moe_layer(cuda, "olmoe-1b-7b", dtype, 4, 7)
    a = MD.moe_decode(x, *route, p["wi"], p["wo"], gs=gs, cap=cap)
    b = MD.moe_decode(x, *route, p["wi"], p["wo"], gs=gs, cap=cap)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch,B", [("olmoe-1b-7b", 4), ("olmoe-1b-7b", 16),
                                    ("granite-moe-1b-a400m", 16)])
def test_moe_decode_counter_counts_distinct_kept_experts(cuda, arch, B):
    _, p, x, route, gs, cap = _moe_layer(cuda, arch, torch.bfloat16, B, 11)
    counter = MD.experts_read(cuda)
    before = int(counter.item())
    MD.moe_decode(x, *route, p["wi"], p["wo"], gs=gs, cap=cap)
    top_e, pos, _ = route
    want = len(set(top_e[pos < cap].tolist()))
    assert int(counter.item()) - before == want


# ------------------------------------------------------------- serving
def _kernel_counters():
    from repro_torch.serving.graphs import COUNTED
    return {f.__name__: f for f in COUNTED}


def _per_step(cfg, B):
    """Kernel launches of one decode step of batch B: decode once per
    attention and cross-attention layer, but for the global layers of an
    int8 KV cache (plain PyTorch); none for mLSTM / sLSTM blocks; the MoE
    kernels' launches per MoE layer where B rows give at most R_MAX rows
    per expert."""
    pat, n_per, n_rem = M.layer_layout(cfg)
    kinds = list(pat) * n_per + list(pat[:n_rem])
    n_attn = sum(k.startswith("attn") for k in kinds)
    if cfg.kv_quant == "int8":
        n_attn -= kinds.count("attn_global")
    n_cross = len(kinds) if cfg.encoder_layers else 0
    moe = cfg.moe is not None and L.moe_rows(cfg, B) <= MD.R_MAX
    return {"flash_attention": 0, "decode_attention": n_attn + n_cross,
            "rglru_scan": 0,
            "moe_decode": MD.LAUNCHES * cfg.n_layers if moe else 0}


@pytest.mark.parametrize("arch,n_dec,cfg_kw", [("granite-8b", 6, {}),
                                               ("qwen2.5-32b", 6, {}),
                                               ("recurrentgemma-2b", 20, {}),
                                               ("granite-moe-1b-a400m", 6,
                                                {}),
                                               ("olmoe-1b-7b", 6, {}),
                                               ("whisper-large-v3", 6, {}),
                                               ("pixtral-12b", 6, {}),
                                               ("gemma2-9b", 20, {}),
                                               ("gemma3-27b", 20, {}),
                                               ("xlstm-350m", 6, {}), INT8,
                                               OLMOE_SPARSE])
def test_decode_graph_matches_eager_step(cuda, arch, n_dec, cfg_kw):
    """The captured decode step, replayed over a prefill written into its
    static caches, against the eager step on a copy of the same caches:
    logits within 2e-3 and the same greedy tokens at every step
    (recurrentgemma, gemma2 and gemma3 past their window of 16, so the
    ring wraps; xlstm's recurrent state and the int8 cache's codes and
    scales updated in place); each replay adds its captured launches to
    the counters, the capture adds none."""
    from repro_torch.serving.graphs import DecodeGraph
    cfg = get_reduced(arch).with_(**cfg_kw)
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(1), cuda)
    B, T0, vt = 2, 8, cfg.vision_tokens
    cache_len = vt + T0 + n_dec
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T0)).astype(
        np.int32)).to(cuda)
    ex = {}
    if cfg.vision_tokens:
        ex["patch_embeds"] = (B, vt, cfg.d_model)
    if cfg.encoder_layers:
        ex["enc_frames"] = (B, cfg.encoder_seq, cfg.d_model)
    ex = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(cuda) for k, s in ex.items()}
    counters = _kernel_counters()
    static = M.init_cache(cfg, B, cache_len, cuda)
    n0 = {k: f.launches for k, f in counters.items()}
    graph = DecodeGraph(lambda p, t, q, c: M.decode_step(cfg, p, t, q, c),
                        params, static, B, cuda)
    # the warm-up step launched; the capture did not
    assert {k: f.launches - n0[k] for k, f in counters.items()} == \
        _per_step(cfg, B)
    assert graph.launches() == _per_step(cfg, B)
    n_moe = counters["moe_decode"].launches
    logits, _, _ = M.prefill(cfg, params, toks, cache_len=cache_len,
                             caches=static, **ex)
    assert counters["moe_decode"].launches == n_moe  # never at prefill
    eager = {k: {p: {n: t.clone() for n, t in c.items()}
                 for p, c in g.items()} for k, g in static.items()}
    tok_g = tok_e = logits.argmax(-1).to(torch.int32)[:, None]
    for i in range(n_dec):
        pos = torch.full((B,), vt + T0 + i, dtype=torch.int32, device=cuda)
        n0 = {k: f.launches for k, f in counters.items()}
        tok_g, lg = graph(tok_g, pos)
        assert {k: f.launches - n0[k] for k, f in counters.items()} == \
            _per_step(cfg, B)
        le, eager = M.decode_step(cfg, params, tok_e, pos, eager)
        tok_e = le.argmax(-1).to(torch.int32)[:, None]
        torch.testing.assert_close(lg, le, rtol=2e-3, atol=2e-3,
                                   msg=lambda m: f"step {i}: {m}")
        assert torch.equal(tok_g, tok_e), f"step {i}"


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2.5-32b",
                                  "gemma2-9b"])
def test_head_bf16_gemm_matches_widened_product(cuda, arch):
    """On the card ``_head`` runs bf16 ``h`` and the bf16 weight through
    one GEMM with an fp32 result: equal to the product of both widened to
    fp32 within 1e-5 of its scale (the products are exact in fp32; only
    the summation order differs), for a tied head (granite-8b), an
    untied one (qwen2.5-32b) and a final softcap (gemma2-9b), on decode's
    (B, D) and score's (B, S, D) hidden states; under autograd it widens
    both (``mm.dtype`` has no derivative)."""
    cfg = get_reduced(arch).with_(dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    rng = np.random.default_rng(3)
    for shape in ((4, cfg.d_model), (2, 5, cfg.d_model)):
        h = _rand(rng, shape, torch.bfloat16, cuda)
        got = M._head(cfg, params, h)
        want = L.softcap(h.float() @ w.float(), cfg.final_softcap)
        assert got.dtype == torch.float32 and got.shape == want.shape
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
        hg = h.clone().requires_grad_()
        out = M._head(cfg, params, hg)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        out.sum().backward()
        assert hg.grad.shape == h.shape


def test_check_range_asserts_on_device(cuda):
    """``_check_range`` on the card adds no host sync (it runs under
    ``set_sync_debug_mode("error")``); an out-of-range decode position
    then fails loudly as a device-side assert, at the latest at the next
    sync (the assert ends the CUDA context: so in a child process)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    idx = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        M._check_range(idx, 6, "index")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    code = (
        "import torch\n"
        "from repro_torch.configs import get_reduced\n"
        "from repro_torch.models import model as M\n"
        "cfg = get_reduced('granite-8b')\n"
        "p = M.init_params(cfg, torch.Generator('cuda').manual_seed(0),"
        " 'cuda')\n"
        "c = M.init_cache(cfg, 1, 8, 'cuda')\n"
        "tok = torch.zeros((1, 1), dtype=torch.int32, device='cuda')\n"
        "torch.cuda.synchronize()\n"
        "print('set up', flush=True)\n"
        "M.decode_step(cfg, p, tok, torch.tensor([8], dtype=torch.int32,"
        " device='cuda'), c)\n"
        "torch.cuda.synchronize()\n"
        "print('synced', flush=True)\n")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert "set up" in out.stdout and "synced" not in out.stdout, \
        out.stderr[-2000:]
    assert out.returncode != 0
    assert "device-side assert" in out.stderr, out.stderr[-2000:]


def test_evicted_engine_frees_card_memory(cuda):
    """An EnginePool eviction drops the engine's weights, static caches,
    decode graphs and their scratch: the card then holds what the warm
    engine held at its admission and no more."""
    import gc
    import weakref
    from repro_torch.serving import EnginePool, ServingEngine

    class Measured(ServingEngine):
        def cold_start(self):
            m0 = torch.cuda.memory_allocated()
            s = super().cold_start()
            self.held = torch.cuda.memory_allocated() - m0
            return s

    def builder(arch):
        return lambda: Measured(get_reduced(arch), batch_size=2,
                                prefill_len=8, max_len=24, device="cuda")

    # the process's one-time allocations (cuBLAS workspaces of the
    # default and the capture streams) come before the baseline, and so
    # does PyTorch's graph-safe RNG state (two 512-byte blocks held while
    # any CUDA graph lives): a one-op graph stays alive over the test
    x = torch.zeros(1, device=cuda)
    keeper = torch.cuda.CUDAGraph()
    with torch.cuda.graph(keeper):
        x.add_(1)
    warm = builder("whisper-large-v3")()
    warm.cold_start()
    warm.serve("transcribe", np.ones((2, 8), np.int32), max_new_tokens=2)
    del warm
    gc.collect()
    base = torch.cuda.memory_allocated()
    pool = EnginePool({a: builder(a) for a in ("granite-8b",
                                               "whisper-large-v3")},
                      max_warm=1)
    toks = np.ones((2, 8), np.int32)
    pool.dispatch("granite-8b", "generate", toks, max_new_tokens=4)
    first = pool.warm["granite-8b"]
    graph = weakref.ref(first.registry["compile.generate"].value["graph"])
    embed = weakref.ref(first._params["embed"])
    assert first.held > 0
    pool.dispatch("whisper-large-v3", "transcribe", toks, max_new_tokens=4)
    assert pool.evictions == ["granite-8b"]
    gc.collect()
    assert graph() is None and embed() is None and first._params is None
    held = pool.warm["whisper-large-v3"].held
    assert torch.cuda.memory_allocated() - base <= held
    del keeper


def test_concurrent_serves_equal_sequential_on_card(cuda):
    """Threads serving on one CUDA engine at once (its decode graph
    replays into static buffers) get the tokens of sequential serves."""
    import threading
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(get_reduced("granite-moe-1b-a400m"), batch_size=2,
                        prefill_len=8, max_len=24, device="cuda")
    eng.cold_start()
    assert "graph" in eng.registry["compile.generate"].value
    rng = np.random.default_rng(8)
    reqs = [rng.integers(0, eng.cfg.vocab, (2, 8)) for _ in range(6)]
    want = [eng.serve("generate", t, max_new_tokens=8)[0] for t in reqs]
    got = [None] * len(reqs)

    def serve(i):
        got[i] = eng.serve("generate", reqs[i], max_new_tokens=8)[0]

    threads = [threading.Thread(target=serve, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ training
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,hd,window,cap,chunk", [
    (2, 4, 2, 128, 128, None, None, 0),
    (1, 8, 2, 200, 128, None, None, 64),  # ragged S and chunk
    (2, 4, 1, 130, 64, 48, None, 32),  # window, MQA
    (1, 4, 2, 100, 256, None, 50.0, 0),  # softcap
    (2, 2, 2, 77, 16, 20, 30.0, 16),  # the SIMT instance
])
def test_flash_autograd_matches_plain(cuda, B, H, K, S, hd, window, cap,
                                      chunk, dtype):
    """flash_attention_fn (kernel forward, plain chunked backward) on the
    card against autograd through flash_attention_plain."""
    from repro_torch.kernels.flash_attention import flash_attention_fn
    rng = np.random.default_rng(S)
    q = _rand(rng, (B, H, S, hd), dtype, cuda)
    k = _rand(rng, (B, K, S, hd), dtype, cuda)
    v = _rand(rng, (B, K, S, hd), dtype, cuda)
    do = _rand(rng, (B, H, S, hd), dtype, cuda)
    kw = dict(causal=True, window=window, softcap=cap)
    n0 = flash_attention.launches
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention_fn(*ins, chunk=chunk, **kw)
    got = torch.autograd.grad(o, ins, do)
    assert flash_attention.launches == n0 + 1  # the forward only
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ins, **kw), ins, do)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R,with_h0", [(2, 64, 256, False),
                                           (3, 37, 130, True)])
def test_rglru_autograd_matches_plain(cuda, B, S, R, with_h0, dtype):
    """rglru_scan_fn on the card (two kernel launches: the forward and
    the reverse-time backward) against autograd through the plain
    version."""
    from repro_torch.kernels.rglru_scan import rglru_scan_fn
    rng = np.random.default_rng(R)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, R)).astype(
        np.float32)).to(cuda, dtype)
    b = _rand(rng, (B, S, R), dtype, cuda)
    dh = _rand(rng, (B, S, R), dtype, cuda)
    h0 = _rand(rng, (B, R), torch.float32, cuda) if with_h0 else None
    n0 = rglru_scan.launches
    ins = [a.clone().requires_grad_(), b.clone().requires_grad_()] + (
        [h0.clone().requires_grad_()] if with_h0 else [])
    got = torch.autograd.grad(rglru_scan_fn(*ins), ins, dh)
    assert rglru_scan.launches == n0 + 2
    ins = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(rglru_scan_plain(*ins), ins, dh)
    for x, y in zip(got, want):
        torch.testing.assert_close(x.float(), y.float(), **TOL[dtype])


@pytest.mark.parametrize("arch", ["granite-8b", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m",
                                  "whisper-large-v3", "gemma2-9b"])
def test_train_step_cuda_matches_cpu(cuda, arch):
    """One reduced fp32 train step (remat per block) on the card against
    the same step on the CPU: loss and grad norm (2e-4), the grads and
    the updated parameters (2e-4 of each leaf's scale plus 2e-5;
    recurrentgemma and whisper sit on a measured fp32 noise floor, see
    tests/test_torch_grads.py: 1e-2 and 1e-3)."""
    from repro_torch.training.adamw import adamw_init
    from repro_torch.training.step import make_train_step
    from repro_torch.training.tree import tree_map
    cfg = get_reduced(arch)
    rtol = {"recurrentgemma-2b": 1e-2, "whisper-large-v3": 1e-3}.get(
        arch, 2e-4)
    params = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 24)),
             "labels": rng.integers(0, cfg.vocab, (2, 24))}
    if cfg.encoder_layers:
        batch["enc_frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        # a copy on each device: the step updates its params in place
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        grads = []
        step = make_train_step(cfg, lr=1e-3, compress_fn=lambda g: (
            grads.append(g), g)[1])
        p, _, m = step(p, adamw_init(p), {k: torch.as_tensor(v, device=dev)
                                          for k, v in batch.items()})
        out[str(dev)] = (m, grads[0], p)
    (mc, gc, pc), (mg, gg, pg) = out["cpu"], out["cuda"]
    for k in mc:  # the grad norm is held as the grads are
        torch.testing.assert_close(
            mg[k].cpu(), mc[k], atol=2e-5,
            rtol=rtol if k == "grad_norm" else 2e-4)
    # grads, and the parameters AdamW moved by them, to each leaf's scale;
    # k's bias has a zero gradient (a shift of every score of a query by
    # one value), which fp32 leaves as noise on both devices: it is held
    # to zero at the scale of the same layer's wk gradient
    grads_c = dict(M._leaves(gc))
    for name, a in M._leaves(gg):
        b = grads_c[name]
        if name.endswith("/bk"):
            scale = grads_c[name[:-2] + "wk"].abs().max().item()
            for g in (a.cpu(), b):
                assert g.abs().max().item() <= rtol * scale + 2e-5, name
            continue
        err = (a.cpu() - b).abs().max().item()
        assert err <= rtol * b.abs().max().item() + 2e-5, name
    # (Adam moves a k bias by lr times the sign of that noise: not held)
    params_c = dict(M._leaves(pc))
    for name, a in M._leaves(pg):
        if not name.endswith("/bk"):
            b = params_c[name]
            err = (a.cpu() - b).abs().max().item()
            assert err <= rtol * b.abs().max().item() + 2e-5, name


# ------------------------------------------------ DTensors on one card


@pytest.fixture
def nccl_mesh(cuda):
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_debug_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _dt(t, mesh, *placements):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements, run_check=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_on_local_shards_match_plain_tensors(nccl_mesh, dtype):
    """``ops`` on CUDA DTensors launches each kernel once, on the local
    shards, and gives what the kernel gives on plain tensors, bit for
    bit."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    mesh, dev = nccl_mesh, torch.device("cuda")
    B, S, K, G, hd, T = 2, 64, 2, 2, 128, 96
    q = _rand(rng, (B, S, K, G, hd), dtype, dev)
    k = _rand(rng, (B, S, K, hd), dtype, dev)
    v = _rand(rng, (B, S, K, hd), dtype, dev)
    pos = torch.arange(S, device=dev).expand(B, S)
    flash_attention.launches = decode_attention.launches = 0
    rglru_scan.launches = 0
    want = ops.attention_op(q, k, v, positions=pos)
    got = ops.attention_op(_dt(q, mesh, Shard(0), Shard(2)),
                           _dt(k, mesh, Shard(0), Replicate()),
                           _dt(v, mesh, Shard(0), Replicate()),
                           positions=_dt(pos, mesh, Shard(0), Replicate()))
    assert torch.equal(got.to_local(), want)
    assert flash_attention.launches == 2
    qd = _rand(rng, (B, 1, K, G, hd), dtype, dev)
    kc = _rand(rng, (B, T, K, hd), dtype, dev)
    vc = _rand(rng, (B, T, K, hd), dtype, dev)
    qp = torch.tensor([70, 95], dtype=torch.int32, device=dev)
    kvp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    want = ops.decode_attention_op(qd, kc, vc, qp, kvp)
    got = ops.decode_attention_op(
        _dt(qd, mesh, Shard(0), Shard(2)), _dt(kc, mesh, Shard(0), Shard(1)),
        _dt(vc, mesh, Shard(0), Shard(1)), _dt(qp, mesh, Shard(0),
                                               Replicate()),
        _dt(kvp, mesh, Shard(0), Replicate()))
    assert torch.equal(got.to_local(), want)
    assert decode_attention.launches == 2
    a = torch.rand((B, S, 256), device=dev).to(dtype)
    b = _rand(rng, (B, S, 256), dtype, dev)
    want = ops.rglru_op(a, b)
    got = ops.rglru_op(_dt(a, mesh, Shard(0), Shard(2)),
                       _dt(b, mesh, Shard(0), Replicate()))
    assert torch.equal(got.to_local(), want)
    assert rglru_scan.launches == 2


def test_cuda_dtensor_never_reaches_a_wrapper_whole(nccl_mesh):
    """The raw wrappers refuse a CUDA DTensor (the kernel would read its
    data pointer, not a shard's); a meshed reduced decode step runs
    through ``ops``, which hands them local shards."""
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed import (batch_pspec, distribute_params,
                                         distribute_tree)
    from repro_torch.models.partition import use_mesh
    mesh, dev = nccl_mesh, torch.device("cuda")
    q = _dt(torch.zeros((1, 2, 8, 64), device=dev), mesh, Replicate(),
            Replicate())
    with pytest.raises(TypeError, match="local shards"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="local shards"):
        rglru_scan(q[0], q[0])
    cfg = get_reduced("recurrentgemma-2b")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0), dev)
    tok = torch.randint(0, cfg.vocab, (2, 16), device=dev,
                        dtype=torch.int32)

    def place(t, n):
        spec = batch_pspec(mesh, batch_size=2, extra_dims=n)
        return distribute_tree({"t": t}, {"t": spec}, mesh)["t"]
    with torch.no_grad():
        want, caches, _ = M.prefill(cfg, params, tok, cache_len=20)
        wd, _ = M.decode_step(cfg, params, want.argmax(-1).to(
            torch.int32)[:, None], torch.full((2,), 16, dtype=torch.int32,
                                              device=dev), caches)
        flash_attention.launches = decode_attention.launches = 0
        with use_mesh(mesh):
            dparams = distribute_params(params, cfg, mesh)
            got, caches, _ = M.prefill(cfg, dparams, place(tok, 1),
                                       cache_len=20)
            gd, _ = M.decode_step(cfg, dparams, place(want.argmax(-1).to(
                torch.int32)[:, None], 1), place(torch.full(
                    (2,), 16, dtype=torch.int32, device=dev), 0), caches)
    assert flash_attention.launches > 0 and decode_attention.launches > 0
    torch.testing.assert_close(got.full_tensor(), want, rtol=2e-3,
                               atol=2e-3)
    torch.testing.assert_close(gd.full_tensor(), wd, rtol=2e-3, atol=2e-3)


def test_check_range_on_a_dtensor_asserts_on_device(cuda):
    """``_check_range`` on a CUDA DTensor checks its local shard on the
    card: no host sync, and an index out of range is a device-side assert
    (in a child process: the assert ends the CUDA context)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = (
        "import socket, torch\n"
        "import torch.distributed as dist\n"
        "from torch.distributed.tensor import DTensor, Shard, Replicate\n"
        "from repro_torch.launch.mesh import make_debug_mesh\n"
        "from repro_torch.models import model as M\n"
        "s = socket.socket(); s.bind(('localhost', 0))\n"
        "port = s.getsockname()[1]; s.close()\n"
        "dist.init_process_group('nccl', init_method=f'tcp://localhost:"
        "{port}', world_size=1, rank=0, device_id=torch.device('cuda', 0))\n"
        "mesh = make_debug_mesh((1, 1))\n"
        "def dt(v):\n"
        "    t = torch.tensor(v, dtype=torch.int32, device='cuda')\n"
        "    return DTensor.from_local(t, mesh, [Shard(0), Replicate()],\n"
        "                              run_check=False)\n"
        "good = dt([0, 5])\n"
        "torch.cuda.set_sync_debug_mode('error')\n"
        "M._check_range(good, 6, 'index')\n"
        "torch.cuda.set_sync_debug_mode('default')\n"
        "torch.cuda.synchronize()\n"
        "print('set up', flush=True)\n"
        "M._check_range(dt([0, 6]), 6, 'index')\n"
        "torch.cuda.synchronize()\n"
        "print('synced', flush=True)\n")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert "set up" in out.stdout and "synced" not in out.stdout, \
        out.stderr[-2000:]
    assert out.returncode != 0
    assert "device-side assert" in out.stderr, out.stderr[-2000:]


def test_checkpoint_recompute_keeps_act_mode_on_the_card(cuda):
    """A CUDA backward runs on the autograd engine's device thread, not
    the caller's: a checkpointed block's recompute there still sees the
    forward's mesh and act mode (``partition.in_this_context``)."""
    from repro_torch.models import partition as TP
    seen = []

    def fn(x):
        seen.append((TP.current_mesh(), TP.act_mode()))
        return x.sin()
    mesh = object()
    x = torch.ones(3, device=cuda, requires_grad=True)
    with TP.use_mesh(mesh), TP.use_act_mode("sp"):
        M._checkpointed(fn)(x).sum().backward()
    assert seen == [(mesh, "sp")] * 2


def test_serve_span_device_times_on_a_graphed_engine(cuda):
    """A graphed engine's spans: ``graph_capture`` inside its
    ``compile.generate`` component and within 1 ms of
    ``DecodeGraph.capture_s`` (the span wraps the constructor that times
    itself); the ``serve`` span's ``decode_device_ms / decode_steps``
    within 20% of the same graph's replays timed here by CUDA events;
    and under a CUDA profiler session, with the tracer left off, the
    serve's device intervals inside its span (one clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import tracing
    from repro_torch.serving import ServingEngine
    cfg = get_reduced("granite-8b")
    tr = tracing.get_tracer()
    tr.clear()
    tracing.configure_tracing(enabled=True)
    try:
        eng = ServingEngine(cfg, seed=0, batch_size=2, prefill_len=16,
                            max_len=80, device="cuda")
        eng.cold_start()
        graph = eng.registry["compile.generate"].value["graph"]
        spans = {s.span_id: s for s in tr.snapshot()}
        cap = [s for s in spans.values() if s.name == "graph_capture"]
        assert len(cap) == 1
        comp = spans[cap[0].parent_id]
        assert comp.attrs == {"name": "compile.generate", "group": "compile"}
        cap_s = (cap[0].end_ns - cap[0].start_ns) / 1e9
        assert comp.start_ns <= cap[0].start_ns <= cap[0].end_ns <= \
            comp.end_ns
        assert graph.capture_s - 1e-4 <= cap_s <= graph.capture_s + 1e-3

        toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
        eng.serve("generate", toks, max_new_tokens=4)
        tr.clear()
        eng.serve("generate", toks, max_new_tokens=33)
        serve = next(s for s in tr.snapshot() if s.name == "serve")
        steps = serve.attrs["decode_steps"]
        assert steps == 32
        got = serve.attrs["decode_device_ms"] / steps
        assert 0 < serve.attrs["prefill_device_ms"]
        assert serve.attrs["prefill_device_ms"] + \
            serve.attrs["decode_device_ms"] <= serve.duration_ms
        tok = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(steps):
            tok, _ = graph(tok, 16 + i)
            tok[:, 0].clone()
        b.record()
        torch.cuda.synchronize()
        want = a.elapsed_time(b) / steps
        assert abs(got - want) <= 0.2 * want, (got, want)

        tracing.configure_tracing(enabled=False)
        tr.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.serve("generate", toks, max_new_tokens=9)
        (serve,) = [s for s in tr.snapshot() if s.name == "serve"]
        dev = [(e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", lambda: False)()]
        assert dev
        total = sum(e - s for s, e in dev)
        inside = sum(max(0, min(e, serve.end_ns) - max(s, serve.start_ns))
                     for s, e in dev)
        assert inside >= 0.99 * total, (inside, total)
    finally:
        tracing.configure_tracing(enabled=False)
        tr.clear()


def test_serve_span_counts_the_experts_a_graphed_moe_decode_reads(cuda):
    """A graphed reduced-olmoe engine at capacity 1.25 and batch 2 (one
    row per expert: its decode step runs the expert-sparse kernels): the
    ``serve`` span's ``moe_experts_read`` is the counter's increase over
    the decode steps, between one expert a layer a step (two tokens,
    top-2, each kept slot's expert) and all of them; ``moe_expert_slots``
    is experts x layers x steps."""
    from repro_torch.obs import tracing
    from repro_torch.serving import ServingEngine
    cfg = get_reduced("olmoe-1b-7b").with_(**SPARSE_MOE)
    tr = tracing.get_tracer()
    tr.clear()
    try:
        eng = ServingEngine(cfg, seed=0, batch_size=2, prefill_len=16,
                            max_len=48, device="cuda")
        eng.cold_start()
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
        counter = MD.experts_read(cuda)
        tracing.configure_tracing(enabled=True)
        before = int(counter.item())
        eng.serve("generate", toks, max_new_tokens=9)
        read = int(counter.item()) - before
        (serve,) = [s for s in tr.snapshot() if s.name == "serve"]
        steps, E = 8, cfg.moe.n_experts
        assert serve.attrs["moe_expert_slots"] == E * cfg.n_layers * steps
        assert serve.attrs["moe_experts_read"] == read
        assert cfg.n_layers * steps <= read <= E * cfg.n_layers * steps
    finally:
        tracing.configure_tracing(enabled=False)
        tr.clear()
