#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. device  -- require CUDA; print the card's name and power limit
              (nvidia-smi), the torch and nvcc versions;
2. build   -- build every kernel under src/repro_torch/kernels/csrc with
              nvcc (one process per source, in parallel), timed as set-up;
3. kernels -- hold each kernel against its plain PyTorch version on the
              card, at the main path's shapes (granite-8b, batch 4,
              prefill 512, cache 640) and at small windowed / softcapped
              / ragged / ring-buffer shapes, in bf16 (tolerance 3e-2) and
              fp32 (2e-5); time kernel, plain version and one PyTorch
              library call (scaled_dot_product_attention, a yardstick the
              port never calls);
4. parity  -- granite-8b reduced() in fp32: the CUDA model (kernels)
              against the CPU model (plain versions) on the same params:
              prefill logits, every cache leaf, 5 decode steps, 2e-3;
5. serve   -- the main path: ServingEngine for full-width granite-8b
              (36 layers, d_model 4096, random weights from a seed),
              cold_start(), 3 ``generate`` requests of 16 new tokens and 1
              ``score`` request, with the launch counters set to 0 just
              before and read just after;
6. breakdown -- for information: prefill and decode-step times, and a
              torch.profiler trace of one request (device busy share,
              kernel time by kind).

It prints one JSON line per kernel summary (``{"kernels": [...]}``) and
ends with ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): used for bound_ms
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": dict(rtol=3e-2, atol=3e-2),
       "float32": dict(rtol=2e-5, atol=2e-5)}
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "granite-8b"
BATCH, PREFILL, CACHE, NEW_TOKENS, N_GENERATE = 4, 512, 640, 16, 3
L2_BYTES = 50 * 2**20


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# ------------------------------------------------------------------ timing
def time_ms(fn, sets, iters=20, warmup=3):
    """Mean ms per call of fn(*s), cycling over input sets whose total
    size exceeds the L2 cache, so each call finds its inputs in HBM."""
    import torch
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(nbytes):
    return max(2, math.ceil(2 * L2_BYTES / nbytes))


# ------------------------------------------------------------ phase 1 + 2
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from repro_torch.kernels import _build
    smi = nvidia_smi()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()}")
    nv = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    log(f"[device] nvcc: {nv[-1]}")
    # fp32 comparisons need full-precision matmuls (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] allow_tf32 = False (cuda.matmul and cudnn)")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(logs)} sources compiled in {dt:.3f} s "
        f"(into {_build.build_dir()})")


# --------------------------------------------------------------- phase 3
def _rand(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _check(name, got, want, dtype_name, case):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[dtype_name],
                               msg=lambda m: f"{name} {case}: {m}")
    log(f"[kernels] {name} {dtype_name} {case}: max_abs_err {err:.3e} ok")
    return err


def flash_cases(gen):
    """Flash kernel vs plain on the card; returns the summary entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    B, H, K, hd, S = BATCH, 32, 8, 128, PREFILL
    G = H // K
    main = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        # main path shape, in model layout: q (B,S,K,G,hd), k/v (B,S,K,hd),
        # handed to the kernel as transposed views, as attn_apply does
        q5 = _rand(gen, (B, S, K, G, hd), dt)
        k4 = _rand(gen, (B, S, K, hd), dt)
        v4 = _rand(gen, (B, S, K, hd), dt)
        args = (q5.reshape(B, S, H, hd).transpose(1, 2),
                k4.transpose(1, 2), v4.transpose(1, 2))
        got = flash_attention(*args, causal=True)
        torch.cuda.synchronize()
        want = flash_attention_plain(*args, causal=True)
        main[dn] = _check("flash_attention", got, want, dn,
                          f"B={B} H={H} K={K} S={S} hd={hd} causal")
        for (b, h, kk, sq, skv, d, causal, window, cap, what) in [
                (1, 4, 1, 40, 40, 32, True, 16, None, "MQA+window"),
                (1, 2, 2, 33, 33, 16, True, None, 30.0, "softcap+ragged"),
                (1, 4, 2, 100, 100, 64, True, None, None, "ragged GQA"),
                (1, 2, 2, 16, 80, 16, False, None, None, "bidir Sq!=Skv")]:
            q = _rand(gen, (b, h, sq, d), dt)
            k = _rand(gen, (b, kk, skv, d), dt)
            v = _rand(gen, (b, kk, skv, d), dt)
            kw = dict(causal=causal, window=window, softcap=cap)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            _check("flash_attention", got, flash_attention_plain(q, k, v,
                                                                 **kw),
                   dn, what)

    # timing at the main path's shape and type (bf16), cold L2
    dt = torch.bfloat16
    one = 2 * (B * S * H * hd + 2 * B * S * K * hd)
    sets = []
    for _ in range(n_sets(one)):
        q5 = _rand(gen, (B, S, K, G, hd), dt)
        k4 = _rand(gen, (B, S, K, hd), dt)
        v4 = _rand(gen, (B, S, K, hd), dt)
        sets.append((q5.reshape(B, S, H, hd).transpose(1, 2),
                     k4.transpose(1, 2), v4.transpose(1, 2)))
    n0 = flash_attention.launches
    ms = time_ms(lambda q, k, v: flash_attention(q, k, v, causal=True),
                 sets)
    plain_ms = time_ms(lambda q, k, v: flash_attention_plain(
        q, k, v, causal=True), sets)
    lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), sets)
    flash_attention.launches = n0  # timing launches are not the path's
    pairs = S * (S + 1) // 2  # causal (q, k) pairs per head
    flops = 4 * B * H * pairs * hd
    byts = 2 * (2 * B * H * S * hd) + 2 * (2 * B * K * S * hd)
    return _entry("flash_attention", "flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:92", main["bfloat16"],
                  ms, plain_ms, lib_ms, flops, byts, "bfloat16")


def decode_cases(gen):
    """Decode kernel vs plain on the card; returns the summary entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    B, K, G, hd, S = BATCH, 8, 4, 128, CACHE
    n_valid = PREFILL + 8  # a cache partly filled, as mid-generation
    base = torch.arange(S, device="cuda")

    def filled(n):
        kv = torch.where(base < n, base, -1).to(torch.int32)
        return (kv.expand(B, S).contiguous(),
                torch.full((B,), n - 1, dtype=torch.int32, device="cuda"))

    def ring(s, cur, b):
        kv = torch.where(torch.arange(s, device="cuda") <= cur % s,
                         torch.arange(s, device="cuda") + (cur // s) * s,
                         torch.arange(s, device="cuda") + (cur // s - 1) * s)
        return (kv.to(torch.int32).expand(b, s).contiguous(),
                torch.full((b,), cur, dtype=torch.int32, device="cuda"))

    main = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        # main path shape: q (B,1,K,G,hd) and the per-layer cache
        # (B,S,K,hd), handed over as views, as attn_decode does
        q = _rand(gen, (B, 1, K, G, hd), dt)[:, 0]
        kc = _rand(gen, (B, S, K, hd), dt)
        vc = _rand(gen, (B, S, K, hd), dt)
        for what, (kv, qp) in (("partly filled", filled(n_valid)),
                               ("wrapped ring", ring(S, S + 7, B))):
            args = (q, kc.transpose(1, 2), vc.transpose(1, 2), qp, kv)
            got = decode_attention(*args)
            torch.cuda.synchronize()
            err = _check("decode_attention", got,
                         decode_attention_plain(*args), dn,
                         f"B={B} K={K} G={G} S={S} hd={hd} {what}")
            if what == "partly filled":
                main[dn] = err
        for (b, kk, g, s, d, window, cap, what) in [
                (2, 2, 1, 40, 16, 16, None, "ring+window"),
                (1, 2, 2, 33, 16, None, 30.0, "softcap"),
                (1, 1, 4, 48, 16, None, None, "MQA ragged")]:
            qs = _rand(gen, (b, kk, g, d), dt)
            ks = _rand(gen, (b, kk, s, d), dt)
            vs = _rand(gen, (b, kk, s, d), dt)
            if window:
                kv, qp = ring(s, s + 7, b)
            else:
                kvb = torch.arange(s, device="cuda")
                kv = torch.where(kvb < s - 5, kvb, -1).to(
                    torch.int32).expand(b, s).contiguous()
                qp = torch.full((b,), s - 6, dtype=torch.int32,
                                device="cuda")
            kw = dict(window=window, softcap=cap)
            got = decode_attention(qs, ks, vs, qp, kv, **kw)
            torch.cuda.synchronize()
            _check("decode_attention", got,
                   decode_attention_plain(qs, ks, vs, qp, kv, **kw), dn,
                   what)

    dt = torch.bfloat16
    kv, qp = filled(n_valid)
    one = 2 * B * S * K * hd * 2
    sets = []
    for _ in range(n_sets(one)):
        q = _rand(gen, (B, 1, K, G, hd), dt)[:, 0]
        kc = _rand(gen, (B, S, K, hd), dt)
        vc = _rand(gen, (B, S, K, hd), dt)
        sets.append((q, kc.transpose(1, 2), vc.transpose(1, 2)))
    mask = (kv >= 0) & (kv <= qp[:, None])  # (B, S)
    n0 = decode_attention.launches
    ms = time_ms(lambda q, k, v: decode_attention(q, k, v, qp, kv), sets)
    plain_ms = time_ms(lambda q, k, v: decode_attention_plain(
        q, k, v, qp, kv), sets)
    lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q.reshape(B, K * G, 1, hd), k, v, attn_mask=mask[:, None, None],
        enable_gqa=True), sets)
    decode_attention.launches = n0
    # what this run's data needs: k and v of the valid slots, every slot
    # position, q and o
    flops = 4 * B * K * G * n_valid * hd
    byts = 2 * (2 * B * K * n_valid * hd) + 4 * B * S + 4 * B \
        + 2 * (2 * B * K * G * hd)
    return _entry("decode_attention", "decode_attention.cu",
                  "src/repro/kernels/decode_attention.py:70",
                  main["bfloat16"], ms, plain_ms, lib_ms, flops, byts,
                  "bfloat16")


def _entry(name, src, replaces, err, ms, plain_ms, lib_ms, flops, byts,
           dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = byts / PEAK_BYTES_S * 1e3
    e = {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}",
         "replaces": replaces, "launches": 0, "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops > t_bytes else "bytes",
         "library_ms": lib_ms}
    log(f"[kernels] {name} bf16 timing: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
        f"{e['bound_ms']:.4f} ms ({e['bound_by']}: {flops:.4g} flop, "
        f"{byts:.4g} B)")
    return e


# --------------------------------------------------------------- phase 4
def phase_parity():
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    cfg = get_reduced(ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}
    params_gpu = to_cuda(params)
    B, T0, n_dec = 2, 8, 5
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, T0 + n_dec)).astype(np.int32))
    lc, cc, _ = M.prefill(cfg, params, toks[:, :T0], cache_len=T0 + n_dec)
    lg, cg, _ = M.prefill(cfg, params_gpu, toks[:, :T0].cuda(),
                          cache_len=T0 + n_dec)
    errs = [_close(lg, lc, "prefill logits")]
    for key in ("k", "v", "pos"):
        errs.append(_close(cg["scan"]["pos0"][key], cc["scan"]["pos0"][key],
                           f"cache {key}"))
    for i in range(n_dec):
        pos = torch.full((B,), T0 + i, dtype=torch.int32)
        tok = toks[:, T0 + i:T0 + i + 1]
        lc, cc = M.decode_step(cfg, params, tok, pos, cc)
        lg, cg = M.decode_step(cfg, params_gpu, tok.cuda(), pos.cuda(), cg)
        errs.append(_close(lg, lc, f"decode step {i} logits"))
    log(f"[parity] {ARCH} reduced fp32, CUDA kernels vs CPU plain: max "
        f"abs err {max(errs):.3e} (tolerance 2e-3) ok")


def _close(got, want, what):
    import torch
    got, want = got.cpu(), want.cpu()
    torch.testing.assert_close(got, want, **MODEL_TOL,
                               msg=lambda m: f"parity {what}: {m}")
    return (got.float() - want.float()).abs().max().item()


# --------------------------------------------------------------- phase 5
def phase_serve(kernels):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine
    cfg = get_config(ARCH)
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, batch_size=BATCH, prefill_len=PREFILL,
                        max_len=CACHE, device="cuda")
    cold = eng.cold_start()
    rep = eng.report()
    log(f"[serve] {ARCH} full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {M.param_count(cfg) / 1e9:.3f} B params "
        f"({cfg.dtype})")
    log(f"[serve] cold_start_s {cold:.4f} by_group {rep['by_group']}")
    for row in rep["components"]:
        log(f"[serve]   {row['component']}: init_s {row['init_s']}")

    rng = np.random.default_rng(7)
    flash_attention.launches = 0
    decode_attention.launches = 0
    lat, outs = [], []
    for _ in range(N_GENERATE):
        toks = rng.integers(0, cfg.vocab, (BATCH, PREFILL))
        out, dt = eng.serve("generate", toks, max_new_tokens=NEW_TOKENS)
        lat.append(dt)
        outs.append((toks, out))
    logits, dt_score = eng.serve("score", rng.integers(
        0, cfg.vocab, (BATCH, PREFILL)))
    n_flash = flash_attention.launches
    n_decode = decode_attention.launches

    L = cfg.n_layers
    want_flash = L * (N_GENERATE + 1)
    want_decode = L * (NEW_TOKENS - 1) * N_GENERATE
    log(f"[serve] launches: flash_attention {n_flash} (want {want_flash} = "
        f"{L} per prefill/forward x {N_GENERATE + 1}), decode_attention "
        f"{n_decode} (want {want_decode} = {L} x {NEW_TOKENS - 1} steps x "
        f"{N_GENERATE})")
    if (n_flash, n_decode) != (want_flash, want_decode):
        raise RuntimeError("the main path did not run through the kernels "
                           "as expected")
    for toks, out in outs:
        if out.shape != (BATCH, NEW_TOKENS) or out.min() < 0 \
                or out.max() >= cfg.vocab:
            raise RuntimeError(f"generate: bad tokens {out.shape}")
    if logits.shape != (BATCH, PREFILL, cfg.vocab) \
            or not np.isfinite(logits).all():
        raise RuntimeError("score: logits not finite / wrong shape")
    log(f"[serve] generate latency_s {[round(x, 4) for x in lat]}; "
        f"score latency_s {dt_score:.4f}")
    log(f"[serve] max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[serve] first request tokens[0]: {outs[0][1][0].tolist()}")

    # for information: full-width prefill+decode logits against the
    # teacher-forced forward over the same tokens (bf16 model)
    toks, out = outs[0]
    seq = np.concatenate([toks, out[:, :-1]], axis=1)
    params = eng._params
    t = torch.as_tensor(seq, dtype=torch.int32, device="cuda")
    h, _, _ = M.forward(cfg, params, t)
    full = M._head(cfg, params, h[:, PREFILL - 1:])
    lg, caches, _ = M.prefill(cfg, params, t[:, :PREFILL], cache_len=CACHE)
    steps = [lg]
    for i in range(NEW_TOKENS - 1):
        pos = torch.full((BATCH,), PREFILL + i, dtype=torch.int32,
                         device="cuda")
        lg, caches = M.decode_step(cfg, params,
                                   t[:, PREFILL + i:PREFILL + i + 1], pos,
                                   caches)
        steps.append(lg)
    inc = torch.stack(steps, dim=1)
    rel = ((inc - full).abs().max() / full.abs().max()).item()
    log(f"[serve] info: prefill+decode vs teacher-forced forward logits, "
        f"max abs diff / max abs = {rel:.3e} (bf16)")
    kernels[0]["launches"] = n_flash
    kernels[1]["launches"] = n_decode
    return eng


def phase_breakdown(eng):
    """Where one generate request's time goes, for information: prefill
    and decode-step wall times (host clock around synchronised calls),
    then a torch.profiler trace of one request for the device's busy
    share and its kernel time by kind."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    exes, params = eng.registry["compile.generate"].value, eng._params
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, eng.cfg.vocab, (BATCH, PREFILL)), dtype=torch.int32,
        device="cuda")

    def request(times):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, caches = exes["prefill"](params, toks)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        tok = nxt[:, None]
        for i in range(NEW_TOKENS - 1):
            pos = torch.full((BATCH,), PREFILL + i, dtype=torch.int32,
                             device="cuda")
            t0 = time.perf_counter()
            tok, caches = exes["decode"](params, tok, pos, caches)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)

    times = []
    request(times)
    steps = sorted(times[1:])
    log(f"[breakdown] prefill_s {times[0]:.4f}; decode step_s median "
        f"{steps[len(steps) // 2]:.4f} min {steps[0]:.4f} max "
        f"{steps[-1]:.4f} ({len(steps)} steps)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request([])
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        name = ev.name.lower()
        kind = ("flash_attention" if "flash_fwd" in name else
                "decode_attention" if "decode_" in name else
                "matmul" if any(k in name for k in (
                    "gemm", "nvjet", "xmma", "cutlass", "gemv")) else
                "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us
    busy = sum(by_kind.values())
    if busy == 0:
        log("[breakdown] device busy share: not measured (the profiler "
            "recorded no device events)")
        return
    log(f"[breakdown] profiled request: wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms (share {busy / wall_us:.4f}, "
        f"idle {1 - busy / wall_us:.4f}; profiler overhead included)")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"[breakdown]   {kind}: {us / 1e3:.3f} ms "
            f"({us / busy:.4f} of device time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[breakdown]   top kernel {us / 1e3:.3f} ms: {name[:90]}")


def main():
    import torch
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [flash_cases(gen), decode_cases(gen)]
    phase_parity()
    eng = phase_serve(kernels)
    phase_breakdown(eng)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
