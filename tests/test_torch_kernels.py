"""PyTorch port: the kernels' plain versions against the reference's
Pallas kernels (interpret mode) and jnp oracles, on the cases of
tests/test_kernels.py, in fp32 and bf16 at the reference's tolerances.

On the CPU the port's wrappers run the plain versions (a CUDA kernel
has no interpret mode); the kernels themselves are held against these
plain versions on the card by chip_smoke.py and tests/test_torch_cuda.py.
Inputs are made with numpy from a seed and handed to both packages.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as j_decode,
)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as j_flash,
)
from repro.kernels.rglru_scan import rglru_scan as j_rglru  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, split_plan,
)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    check_rows_aligned as check_decode_rows_aligned,
)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    instance as decode_instance,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_rows_aligned, flash_attention, flash_attention_plain, rows_aligned,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    instance as flash_instance,
)
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan, rglru_scan_plain,
)
from repro_torch.models import layers as TL  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------------- flash
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,K,Sq,Skv,hd,causal,window,cap",
    [
        (2, 4, 2, 64, 64, 32, True, None, None),      # GQA
        (1, 2, 2, 48, 48, 16, True, None, None),      # off-block seq
        (1, 4, 1, 40, 40, 32, True, 16, None),        # MQA + window
        (1, 2, 2, 33, 33, 16, True, None, 30.0),      # softcap + ragged
        (1, 2, 2, 16, 80, 16, False, None, None),     # bidir, Sq != Skv
        (1, 10, 1, 40, 40, 256, True, 16, None),      # recurrentgemma:
        # hd 256, G 10, window; whisper's cross attention: G 1, no mask,
        # Sq != Skv, both ragged against the blocks
        (2, 4, 4, 20, 36, 64, False, None, None),
        (1, 10, 2, 40, 40, 128, True, None, None),    # qwen2.5-32b: G 5
        (1, 4, 4, 24, 24, 128, True, None, None),     # olmoe-1b-7b: G 1
    ])                                                # at hd 128
def test_flash_plain_vs_pallas(B, H, K, Sq, Skv, hd, causal, window, cap,
                               dtype):
    rng = np.random.default_rng(B * 1000 + Sq + Skv)
    jq, tq = _pair(rng, (B, H, Sq, hd), dtype)
    jk, tk = _pair(rng, (B, K, Skv, hd), dtype)
    jv, tv = _pair(rng, (B, K, Skv, hd), dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = flash_attention(tq, tk, tv, **kw)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tq.shape
    pallas = j_flash(jq, jk, jv, block_q=16, block_kv=16, interpret=True,
                     **kw)
    oracle = jref.ref_flash_attention(jq, jk, jv, **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])
    np.testing.assert_allclose(
        _np(tref.ref_flash_attention(tq, tk, tv, **kw)), _np(got), rtol=0,
        atol=0)


# ---------------------------------------------------------------- decode
def _decode_positions(B, S, ring):
    if ring:
        cur = S + 7  # wrapped ring: slot i holds the position with i == p % S
        base = np.arange(S)
        kv_pos = np.where(base <= cur % S, base + (cur // S) * S,
                          base + (cur // S - 1) * S)
        q_pos = np.full((B,), cur)
    else:
        n_valid = S - 5
        kv_pos = np.where(np.arange(S) < n_valid, np.arange(S), -1)
        q_pos = np.full((B,), n_valid - 1)
    kv_pos = np.broadcast_to(kv_pos, (B, S)).astype(np.int32)
    return q_pos.astype(np.int32), np.ascontiguousarray(kv_pos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,K,G,S,hd,window,cap,ring",
    [
        (2, 2, 2, 64, 32, None, None, False),
        (1, 1, 4, 48, 16, None, None, False),   # MQA, ragged S
        (2, 2, 1, 40, 16, 16, None, True),      # ring buffer + window
        (1, 2, 2, 33, 16, None, 30.0, False),   # softcap
        (1, 1, 10, 40, 256, 16, None, True),    # recurrentgemma: hd 256,
        # G 10, wrapped ring; qwen2.5-32b's G 5 and olmoe-1b-7b's G 1, both
        # at hd 128
        (1, 2, 5, 40, 128, None, None, False),
        (2, 4, 1, 33, 128, None, None, False),
    ])
def test_decode_plain_vs_pallas(B, K, G, S, hd, window, cap, ring, dtype):
    rng = np.random.default_rng(B * 100 + S)
    jq, tq = _pair(rng, (B, K, G, hd), dtype)
    jk, tk = _pair(rng, (B, K, S, hd), dtype)
    jv, tv = _pair(rng, (B, K, S, hd), dtype)
    q_pos, kv_pos = _decode_positions(B, S, ring)
    kw = dict(window=window, softcap=cap)
    got = decode_attention(tq, tk, tv, torch.from_numpy(q_pos),
                           torch.from_numpy(kv_pos), **kw)
    pallas = j_decode(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                      block_kv=16, interpret=True, **kw)
    oracle = jref.ref_decode_attention(jq, jk, jv, jnp.asarray(q_pos),
                                       jnp.asarray(kv_pos), **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])


def test_decode_row_without_valid_slot_matches_oracle():
    """A row with no valid slot averages v over the S real slots, as the
    oracle does (the Pallas kernel averages over its padded length:
    S=40 with block 16 gives sum(v)/48).  The model never makes one."""
    rng = np.random.default_rng(5)
    B, K, G, S, hd = 1, 1, 2, 40, 16
    jq, tq = _pair(rng, (B, K, G, hd), "float32")
    jk, tk = _pair(rng, (B, K, S, hd), "float32")
    jv, tv = _pair(rng, (B, K, S, hd), "float32")
    q_pos = np.zeros((B,), np.int32)
    kv_pos = np.full((B, S), -1, np.int32)
    got = _np(decode_attention(tq, tk, tv, torch.from_numpy(q_pos),
                               torch.from_numpy(kv_pos)))
    oracle = _np(jref.ref_decode_attention(jq, jk, jv, jnp.asarray(q_pos),
                                           jnp.asarray(kv_pos)))
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    mean_v = _np(tv).mean(axis=2, keepdims=True)  # (B, K, 1, hd)
    np.testing.assert_allclose(got, np.broadcast_to(mean_v, got.shape),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("batch_kv,S,hd,itemsize,G,want", [
    (32, 640, 128, 2, 4, (160, 4)),   # granite-8b decode: B=4 x K=8
    (4, 2048, 256, 2, 10, (128, 16)),  # recurrentgemma-2b: B=4 x 1 kv
    # head; its byte share (64 slots) gives way to the combine's bound
    (1, 40, 16, 4, 2, (32, 2)),
    (4, 33, 16, 4, 2, (32, 2)),
    (512, 640, 128, 2, 4, (640, 1)),  # enough bytes a pair: no split
    (32, 32768, 128, 2, 4, (7968, 5)),  # long cache: ~4 MB a block
    (1, 65536, 128, 2, 4, (512, 128)),  # held to MAX_SPLIT splits
])
def test_decode_split_plan(batch_kv, S, hd, itemsize, G, want):
    """Each block gets about 1/132 of the call's k/v bytes, in whole
    32-slot tiles, at least sqrt(G * S / 2) slots (the folded combine's
    share), and a (b, kv-head) at most 128 splits."""
    chunk, n_split = split_plan(batch_kv, S, hd, itemsize, G)
    assert (chunk, n_split) == want
    assert chunk % 32 == 0 and (n_split - 1) * chunk < S <= n_split * chunk
    assert n_split <= 128
    assert chunk >= min(S, math.isqrt(G * S // 2))
    tile_bytes = 2 * 32 * hd * itemsize
    share = batch_kv * -(-S // 32) * tile_bytes / 132
    assert n_split == 1 or chunk // 32 * tile_bytes >= share


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 64, "mma"), (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 256, "mma"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt"),
])
def test_decode_instance_by_dtype_and_head_dim(dtype, hd, want):
    """bf16 at head_dim 64/128/256 runs on the tensor cores (mma.sync);
    fp32 and the small bf16 heads stay on the CUDA-core kernel."""
    assert decode_instance(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd,misaligned,raises", [
    (torch.bfloat16, 128, "k", True),
    (torch.bfloat16, 256, "v", True),
    (torch.bfloat16, 16, "k", True),    # the CUDA-core kernel too
    (torch.float32, 128, "v", True),
    (torch.bfloat16, 128, "q", True),   # cp.async copies q: aligned
    (torch.bfloat16, 64, "q", True),
    (torch.bfloat16, 32, "q", False),   # the CUDA-core kernel reads q
    (torch.float32, 128, "q", False),   # element by element
    (torch.bfloat16, 128, None, False),
    (torch.float32, 16, None, False),
])
def test_decode_rows_aligned(dtype, hd, misaligned, raises):
    """Both decode kernels load k and v rows in 16-byte units, and the
    tensor-core kernel q's rows too; the wrapper accepts a view only
    where those rows start on 16-byte boundaries."""
    def rows(name):
        base = torch.zeros((1, 2, 8, hd + 8), dtype=dtype)
        return base[..., 1:hd + 1] if name == misaligned else base[..., :hd]
    q, k, v = rows("q"), rows("k"), rows("v")
    if raises:
        with pytest.raises(ValueError, match=f"rows of {misaligned} "):
            check_decode_rows_aligned(q, k, v)
    else:
        check_decode_rows_aligned(q, k, v)


# ---------------------------------------------------------------- rg-lru
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,R,with_h0", [
    (2, 64, 128, False),
    (1, 40, 130, True),   # ragged channel dim
    (2, 17, 64, True),    # ragged time dim
])
def test_rglru_plain_vs_pallas(B, S, R, with_h0, dtype):
    rng = np.random.default_rng(B * 1000 + S + R)
    # decays in (0, 1) like real RG-LRU coefficients
    x = rng.standard_normal((B, S, R)).astype(np.float32)
    a32 = 1.0 / (1.0 + np.exp(-x))
    jd, td = DTYPES[dtype]
    ja, ta = jnp.asarray(a32).astype(jd), torch.from_numpy(a32).to(td)
    jb, tb = _pair(rng, (B, S, R), dtype)
    jh0, th0 = _pair(rng, (B, R), dtype) if with_h0 else (None, None)
    got = rglru_scan(ta, tb, th0)
    assert got.dtype == td and got.shape == (B, S, R)
    pallas = j_rglru(ja, jb, jh0, block_t=16, block_r=128, interpret=True)
    oracle = jref.ref_rglru_scan(ja, jb, jh0)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])
    np.testing.assert_allclose(_np(tref.ref_rglru_scan(ta, tb, th0)),
                               _np(got), rtol=0, atol=0)
    if dtype == "float32":  # the model-layout wrappers agree too
        np.testing.assert_allclose(_np(tops.rglru_op(ta, tb, th0)),
                                   _np(jops.rglru_op(ja, jb, jh0)),
                                   **TOL[dtype])


# ------------------------------------------------------------ model layout
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(None, None), (8, None),
                                        (None, 30.0)])
def test_attention_op_matches_reference_ops(window, cap, dtype):
    rng = np.random.default_rng(3)
    B, S, K, G, hd = 2, 32, 2, 2, 16
    jq, tq = _pair(rng, (B, S, K, G, hd), dtype)
    jk, tk = _pair(rng, (B, S, K, hd), dtype)
    jv, tv = _pair(rng, (B, S, K, hd), dtype)
    kw = dict(causal=True, window=window, softcap=cap)
    pos = torch.arange(S).expand(B, S)
    got = tops.attention_op(tq, tk, tv, positions=pos, **kw)
    assert got.shape == (B, S, K, G, hd)
    want = jops.attention_op(jq, jk, jv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    if dtype == "float32":  # and against the model's einsum path
        xla = TL.attention(tq, tk, tv, q_positions=pos, kv_positions=pos,
                           causal=True, window=window, softcap_val=cap)
        np.testing.assert_allclose(_np(got), _np(xla), rtol=2e-3,
                                   atol=2e-3)


def test_attention_op_rejects_positions_not_from_zero():
    rng = np.random.default_rng(4)
    _, q = _pair(rng, (1, 8, 1, 2, 16), "float32")
    _, k = _pair(rng, (1, 8, 1, 16), "float32")
    with pytest.raises(ValueError, match="positions 0..S-1"):
        tops.attention_op(q, k, k, positions=torch.arange(8)[None] + 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_op_matches_reference(dtype):
    """Model layout over a live cache: the reference's ops wrapper and the
    model's einsum decode path."""
    rng = np.random.default_rng(6)
    B, T, K, G, hd = 2, 24, 2, 2, 16
    jq, tq = _pair(rng, (B, 1, K, G, hd), dtype)
    jk, tk = _pair(rng, (B, T, K, hd), dtype)
    jv, tv = _pair(rng, (B, T, K, hd), dtype)
    q_pos, kv_pos = _decode_positions(B, T, ring=False)
    got = tops.decode_attention_op(tq, tk, tv, torch.from_numpy(q_pos),
                                   torch.from_numpy(kv_pos))
    want = jops.decode_attention_op(jq, jk, jv, jnp.asarray(q_pos),
                                    jnp.asarray(kv_pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    xla = JL.attention(jq, jk, jv, q_positions=jnp.asarray(q_pos)[:, None],
                       kv_positions=jnp.asarray(kv_pos), causal=True)
    np.testing.assert_allclose(_np(got), _np(xla), **TOL[dtype])


# --------------------------------------------------------------- dispatch
def test_cpu_tensors_never_launch_kernels():
    flash_attention.launches = 0
    decode_attention.launches = 0
    rng = np.random.default_rng(7)
    _, q = _pair(rng, (1, 2, 8, 16), "float32")
    _, k = _pair(rng, (1, 1, 8, 16), "float32")
    flash_attention(q, k, k)
    decode_attention(q[:, :1, :2], k, k, torch.tensor([7], dtype=torch.int32),
                     torch.arange(8, dtype=torch.int32)[None])
    assert flash_attention.launches == 0
    assert decode_attention.launches == 0


def _other_device():
    """Fake tensors on a device with neither a kernel nor a plain route
    (the CPU and meta run the plain versions, CUDA the kernels)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(), "xpu"


def test_no_kernel_for_other_devices():
    mode, dev = _other_device()
    with mode:
        q = torch.empty((1, 2, 8, 16), device=dev)
        k = torch.empty((1, 1, 8, 16), device=dev)
        with pytest.raises(ValueError, match="no kernel"):
            flash_attention(q, k, k)
        with pytest.raises(ValueError, match="no kernel"):
            decode_attention(torch.empty((1, 1, 2, 16), device=dev), k, k,
                             torch.empty((1,), dtype=torch.int32,
                                         device=dev),
                             torch.empty((1, 8), dtype=torch.int32,
                                         device=dev))


def test_meta_tensors_run_the_plain_versions():
    """On the meta device (the dry-run's) each wrapper runs its plain
    version, shapes only, and launches nothing."""
    flash_attention.launches = decode_attention.launches = 0
    rglru_scan.launches = 0
    q = torch.empty((1, 4, 8, 16), device="meta")
    k = torch.empty((1, 2, 8, 16), device="meta")
    assert flash_attention(q, k, k).shape == q.shape
    assert flash_attention(q, k, k, chunk=3).shape == q.shape
    pos = torch.empty((1,), dtype=torch.int32, device="meta")
    o = decode_attention(q[:, :2, :2], k, k, pos,
                         torch.empty((1, 8), dtype=torch.int32,
                                     device="meta"))
    assert o.shape == (1, 2, 2, 16) and o.device.type == "meta"
    a = torch.empty((1, 4, 8), device="meta")
    assert rglru_scan(a, a).shape == a.shape
    assert flash_attention.launches == decode_attention.launches == \
        rglru_scan.launches == 0


def test_plain_flash_query_chunks_match_one_block():
    """The plain version's query blocks give one block's result."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 4, 37, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 2, 37, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 2, 37, 16)).astype(np.float32))
    for kw in (dict(causal=True), dict(causal=True, window=5),
               dict(causal=False, softcap=20.0)):
        want = flash_attention_plain(q, k, v, **kw)
        for chunk in (1, 8, 36):
            got = flash_attention_plain(q, k, v, chunk=chunk, **kw)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_never_launch_rglru_kernel():
    rglru_scan.launches = 0
    rng = np.random.default_rng(12)
    _, a = _pair(rng, (1, 5, 8), "float32")
    _, b = _pair(rng, (1, 5, 8), "float32")
    got = rglru_scan(a, b)
    rglru_scan(a, b, torch.zeros((1, 8)))
    tops.rglru_op(a, b)
    assert rglru_scan.launches == 0
    assert torch.equal(got, rglru_scan_plain(a, b))


def test_rglru_no_kernel_for_other_devices():
    mode, dev = _other_device()
    with mode:
        a = torch.empty((1, 4, 8), device=dev)
        with pytest.raises(ValueError, match="no kernel"):
            rglru_scan(a, a)
        with pytest.raises(ValueError, match="no kernel"):
            rglru_scan(a, a, torch.empty((1, 8), device=dev))


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt"),
])
def test_flash_instance_by_dtype_and_head_dim(dtype, hd, want):
    """bf16 at head_dim 64/128/256 runs on the tensor cores; fp32 (whose
    parity runs need more than TF32's digits) and the small bf16 heads
    stay on the CUDA-core kernel."""
    assert flash_instance(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd,misaligned,raises", [
    (torch.bfloat16, 128, "q", True),    # TMA loads q: must be aligned
    (torch.bfloat16, 256, "q", True),
    (torch.bfloat16, 64, "q", True),
    (torch.bfloat16, 32, "q", False),    # the CUDA-core kernel reads q
    (torch.float32, 128, "q", False),    # element by element
    (torch.bfloat16, 128, "k", True),
    (torch.bfloat16, 128, "v", True),
    (torch.float32, 128, "v", True),
    (torch.bfloat16, 128, None, False),
])
def test_flash_alignment_checked_for_instance(dtype, hd, misaligned,
                                              raises):
    def rows(name):
        base = torch.zeros((1, 2, 8, hd + 8), dtype=dtype)
        return base[..., 1:hd + 1] if name == misaligned else base[..., :hd]
    q, k, v = rows("q"), rows("k"), rows("v")
    if raises:
        with pytest.raises(ValueError, match=f"rows of {misaligned} "):
            check_rows_aligned(q, k, v)
    else:
        check_rows_aligned(q, k, v)


def test_attention_op_positions_shape_checked():
    rng = np.random.default_rng(5)
    _, q = _pair(rng, (2, 8, 1, 2, 16), "float32")
    _, k = _pair(rng, (2, 8, 1, 16), "float32")
    with pytest.raises(ValueError, match="positions 0..S-1"):
        tops.attention_op(q, k, k, positions=torch.arange(8)[None])
    got = tops.attention_op(q, k, k, positions=torch.arange(
        8, dtype=torch.int32).expand(2, 8))
    assert torch.equal(got, tops.attention_op(q, k, k))


def test_flash_rows_aligned():
    """The flash kernel reads k and v rows as 16-byte vectors; its wrapper
    accepts a view only where every row starts on a 16-byte boundary."""
    base = torch.empty((2, 3, 40, 16), dtype=torch.float32)
    assert rows_aligned(base) and rows_aligned(base.transpose(1, 2))
    assert rows_aligned(base.to(torch.bfloat16)[:, :, 1:])  # 32-byte rows
    assert not rows_aligned(base[..., 1:])  # pointer 4 bytes in
    assert not rows_aligned(torch.empty((2, 3, 18))[..., :16])  # 72-byte rows
