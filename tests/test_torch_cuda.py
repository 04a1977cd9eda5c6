"""PyTorch port on the card: each CUDA kernel against its plain version,
and the reduced model's CUDA path against its CPU path.

Marked ``cuda``: skipped (with the reason) where no CUDA card is
present.  Imports neither JAX nor ``repro``, so it runs where only the
port's requirements are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

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
from repro_torch.models import model as M  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


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
@pytest.mark.parametrize("B,H,K,Sq,Skv,hd,causal,window,cap", [
    (2, 8, 2, 130, 130, 128, True, None, None),
    (1, 4, 1, 40, 40, 32, True, 16, None),
    (1, 2, 2, 33, 33, 16, True, None, 30.0),
    (1, 2, 2, 16, 80, 64, False, None, None),
])
def test_flash_kernel_matches_plain(cuda, B, H, K, Sq, Skv, hd, causal,
                                    window, cap, dtype):
    rng = np.random.default_rng(Sq + hd)
    q = _rand(rng, (B, H, Sq, hd), dtype, cuda)
    k = _rand(rng, (B, K, Skv, hd), dtype, cuda)
    v = _rand(rng, (B, K, Skv, hd), dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=cap)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v, **kw).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,S,hd,window,cap", [
    (4, 8, 4, 640, 128, None, None),
    (2, 2, 1, 40, 16, 16, None),
    (1, 2, 2, 33, 32, None, 30.0),
])
def test_decode_kernel_matches_plain(cuda, B, K, G, S, hd, window, cap,
                                     dtype):
    rng = np.random.default_rng(S + hd)
    q = _rand(rng, (B, K, G, hd), dtype, cuda)
    k = _rand(rng, (B, K, S, hd), dtype, cuda)
    v = _rand(rng, (B, K, S, hd), dtype, cuda)
    n_valid = S - 7
    base = torch.arange(S, device=cuda)
    kv_pos = torch.where(base < n_valid, base, -1).to(torch.int32)
    kv_pos = kv_pos.expand(B, S).contiguous()
    q_pos = torch.full((B,), n_valid - 1, dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=cap)
    n0 = decode_attention.launches
    got = decode_attention(q, k, v, q_pos, kv_pos, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    torch.testing.assert_close(got.float(), decode_attention_plain(
        q, k, v, q_pos, kv_pos, **kw).float(), **TOL[dtype])


def test_reduced_model_cuda_matches_cpu(cuda):
    cfg = get_reduced("granite-8b")
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}
    gparams = to(params)
    B, T0, n_dec = 2, 8, 5
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, T0 + n_dec)).astype(np.int32))
    lc, cc, _ = M.prefill(cfg, params, toks[:, :T0], cache_len=T0 + n_dec)
    lg, cg, _ = M.prefill(cfg, gparams, toks[:, :T0].to(cuda),
                          cache_len=T0 + n_dec)
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)
    for i in range(n_dec):
        pos = torch.full((B,), T0 + i, dtype=torch.int32)
        tok = toks[:, T0 + i:T0 + i + 1]
        lc, cc = M.decode_step(cfg, params, tok, pos, cc)
        lg, cg = M.decode_step(cfg, gparams, tok.to(cuda), pos.to(cuda), cg)
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)
