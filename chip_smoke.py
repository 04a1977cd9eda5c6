#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. device  -- require CUDA; print the card's name and power limit
              (nvidia-smi), the torch and nvcc versions;
2. build   -- build every kernel under src/repro_torch/kernels/csrc with
              nvcc (one process per source, in parallel), timed as set-up;
              print registers and spills per instance, the dynamic shared
              memory of the decode ring, and from cuobjdump -sass
              each flash instance's HGMMA (wgmma) and UTMALDG (TMA load)
              counts and each decode instance's HMMA (mma.sync) and LDGSTS
              (cp.async) counts; fail unless the bf16 instances at head_dim
              64, 128 and 256 of both kernels have theirs (they run on the
              tensor cores, fed by asynchronous copies);
3. kernels -- hold each kernel against its plain PyTorch version on the
              card, at the shapes of the main paths -- granite-8b
              (batch 4, prefill 512, cache 640, hd 128, G 4),
              qwen2.5-32b (the same shapes, G 5), olmoe-1b-7b (the same
              shapes, G 1),
              recurrentgemma-2b (batch 4, prefill 2048, window 2048,
              hd 256, G 10 over one kv head; RG-LRU (4, 2048, 2560)),
              granite-moe-1b-a400m (batch 4, prefill 512, cache 640,
              hd 64, G 2), pixtral-12b (batch 4, a 768-token vision
              prefill, 896 cache slots, hd 128, G 4), whisper-large-v3
              (batch 4, hd 64, G 1: the encoder over 1500 frames with no
              mask, the decoder's causal 224-token prefill, cross
              attention from 224 queries over 1500 frames, self decode
              over the 448-slot cache and cross decode over the 1500
              all-valid slots), gemma2-9b (batch 4, hd 256, G 2, softcap
              50: the 4608-token prefill through a local layer (window
              4096) and a global one, decode over the wrapped 4096-slot
              ring and the 4624-slot global cache) and gemma3-27b (batch
              4, hd 128, G 2: the 2048-token prefill through a local
              layer (window 1024) and a global one, decode over the
              wrapped 1024-slot ring and the 2064-slot global cache) --
              and at small windowed / softcapped / ragged (S 130, 200
              against 64- and 128-key tiles) / bidirectional / ring-buffer
              / all-valid shapes, in bf16 (tolerance 3e-2; decode's and
              unmasked flash's 2e-2 relative and 5e-3 absolute, held to
              their outputs' scale) and fp32 (2e-5); time kernel,
              plain version and one PyTorch library call where one
              computes the same function, a yardstick the port never
              calls (scaled_dot_product_attention, with a boolean mask
              for a window shorter than the prompt; with a softcap,
              which SDPA lacks, torch.compile'd flex_attention with the
              softcap as its score_mod; none for the RG-LRU scan) with
              CUDA events (``ms``: includes the wrapper's host path
              where it is the longer);
4. parity  -- reduced() granite-8b, qwen2.5-32b, recurrentgemma-2b,
              granite-moe-1b-a400m, olmoe-1b-7b, pixtral-12b,
              whisper-large-v3,
              gemma2-9b (also with the int8 KV cache), gemma3-27b and
              xlstm-350m in fp32: the CUDA model (kernels) against the
              CPU model (plain versions) on the same params and random
              extras (patch embeddings, encoder frames): prefill logits,
              every cache leaf (whisper's cross_k/cross_v too; int8
              codes to one step), the MoE router load and loss, the
              encoder's output, and decode steps (recurrentgemma's,
              gemma2's and gemma3's run past their window of 16, so the
              ring wraps), 2e-3;
4b. grad   -- reduced granite-8b, recurrentgemma-2b (the RG-LRU
              backward), granite-moe-1b-a400m, whisper-large-v3 (non-
              causal and cross-attention gradients into the encoder) and
              gemma2-9b (window and softcap in the backward) in fp32,
              remat per block, B 2 x S 512 with loss_chunk 512 (so the
              chunked, checkpointed cross-entropy runs): one
              ``make_train_step`` on the card (the kernels' forwards, the
              autograd Functions' backwards) against the same step on
              the CPU from the same params and batch -- the loss and
              metrics and every gradient leaf within 2e-4 of the leaf's
              largest magnitude plus 2e-5 (1e-2 and 1e-3 on
              recurrentgemma and whisper, whose fp32 gradients sit on a
              measured noise floor, tests/test_torch_grads.py); launches
              exact (flash once per attention layer forward and once in
              the recompute, rglru_scan forward, recomputed and
              backward); one checkpoint round trip of the card's (params,
              AdamW state), bit for bit; then at granite-8b's training
              attention shape (B 1, H 32, K 8, S 4096, hd 128, causal,
              bf16) flash_attention_fn's grads against autograd through
              the plain version, 3e-2;
4c. mesh4  -- four gloo ranks on this machine's CPU, on its torch (the
              version is printed), a (2, 2) ("data", "model") mesh:
              reduced granite-moe-1b-a400m and olmoe-1b-7b served meshed
              (fp32, B 4 x S 16, a prefill and 2 decode steps) and
              reduced xlstm-350m's "sp" loss and gradients, each against
              the unmeshed port on the same weights (logits 2e-3 of
              their scale, identical greedy tokens; the loss and every
              gradient leaf 1e-5 of its scale plus 1e-7); a rank's
              exception fails the phase;
5. serve   -- the main paths, one after the other, each engine freed
              before the next: ServingEngine for full-width granite-8b
              (36 layers, d_model 4096), qwen2.5-32b (64 layers, d_model
              5120, 32.8 B parameters), recurrentgemma-2b (26 layers,
              d_model 2560), granite-moe-1b-a400m (24 layers, d_model
              1024, 32 experts top-8), olmoe-1b-7b (16 layers, d_model
              2048, 64 experts top-8), pixtral-12b (40 layers, d_model
              5120), whisper-large-v3 (32 + 32 layers, d_model 1280),
              gemma2-9b (42 layers, d_model 3584; prompt 4608, past its
              4096 window), gemma3-27b (62 layers, d_model 5376; prompt
              2048, past its 1024 window) and xlstm-350m (24 mLSTM /
              sLSTM layers, d_model 1024; prompt 512; no kernel, its
              scans a Python loop over time), random weights from a
              seed; cold_start(), then every entry:
              3 ``generate`` requests of 16 new tokens, 2 of
              ``vision_generate`` / ``transcribe`` with random patch
              embeddings / frames from a seed, and 1 ``score`` request
              (on gemma2 and gemma3 over the prompt's first 512 tokens),
              with the launch counters set to 0 just before each path and
              read just after (counted per entry: a prefill or forward
              launches flash once per attention layer, cross-attention
              layer and encoder layer, a decode step decode once per
              attention and cross-attention layer).  Every decode step
              replays the entry's CUDA graph (captured in
              ``compile.<entry>``); a replay adds to each wrapper's count
              the launches its capture recorded (the capture itself adds
              none), so the counts stay exact.  Then each generating
              entry's graph against the same engine's eager step on the
              same prefill: logits within 2e-3 of their scale and
              identical greedy tokens over the 15 steps.  On
              gemma2-9b also ``kv_quant="int8"`` on the same weights:
              cache bytes against bf16, launches (decode only from the
              21 local layers), greedy agreement with the bf16 cache,
              its phase-6 breakdown, graph against eager;
5b. launcher -- the reference bench's archs (granite-moe-1b-a400m,
              whisper-large-v3, pixtral-12b, qwen2.5-32b) through
              ``repro_torch.launch.serve.run_service`` at their full-width
              shapes, once per policy (eager, lazy, slimstart from the
              eager run's report) on the bench's skewed workload of 24
              requests: cold start by group, deferred components, the
              first hot request's latency, the trace's end-to-end time;
5c. pool    -- EnginePool over full-width granite-8b, granite-moe-1b-
              a400m, whisper-large-v3 and pixtral-12b (batch 4, the phase-5
              sizes), max_warm 2, a seeded sequence of 10 ``generate``
              dispatches (two passes over the four models): paths, victims,
              hits, misses and evictions against the policy; device memory
              after each eviction against what the warm engines held at
              admission; no growth from pass 1 to pass 2; exact launches;
              ``rewarm()``; then queue_depth 2 with 5 threads on one cold
              model (1 build, 2 queued, 2 shed);
5d. batcher -- ContinuousBatcher on full-width granite-8b (4 slots, cache
              640, 12 requests of 64-512 prompt and 4-16 new tokens),
              graphed decode against eager decode: identical tokens, exact
              launches, steps and latencies;
5e. train  -- full-width granite-8b cut to 8 of its 36 layers (weights,
              bf16 grads, fp32 masters and two fp32 moments are 16 B a
              parameter: 36 layers would need ~128 GB), bf16, remat per
              block, batch 4 x 4096 from the port's synthetic pipeline:
              first flash at that attention shape against its plain
              version, timed beside SDPA, and the plain attention
              backward's time; then 6 steps of ``make_train_step`` (lr
              1e-3) on one repeated batch -- loss and grad norm finite,
              the loss falling, flash exactly 16 launches a step -- then
              2 steps with accum_steps 2 and 2 with simulate_int8; for
              information step time, tokens/s, peak memory, MFU against
              the dense bf16 peak, and one profiled step's device time by
              kind (matmul, flash, the plain attention backward,
              elementwise, optimizer);
5f. mesh   -- the sharded serve path on the card: a one-rank NCCL
              process group and a (1, 1) ("data", "model") DeviceMesh;
              full-width granite-8b's parameters distributed by
              ``param_shardings``; a prefill of batch 4 x 512 and 15
              decode steps, eager, under ``use_mesh`` (activation
              constraints bound, caches placed by ``cache_pspecs``),
              twice, against the unmeshed eager path on the same weights:
              flash and decode launched on the DTensors' local shards
              (36 a prefill, 36 a decode step, counted per run), greedy
              tokens identical, logits within 2e-3 of their scale; the
              prefill and decode-step times both ways, for information
              (the difference is DTensor's host cost per op);
5g. dryrun -- ``repro_torch.launch.dryrun.run_cell`` on the meta device
              (a fake process group; this process is rank 0) for
              granite-8b's train_4k, prefill_32k and decode_32k cells on
              the (32, 8) production mesh and decode_32k on (2, 32, 8):
              per-device argument, output and temp bytes against the
              card's 80 GB, FLOPs, bytes and collective bytes by kind;
              fails where a cell whose model axis shards parameters ran
              no collective;
6. breakdown -- for information, after each path: prefill and
              decode-step times with the decode graph (the prefill into
              its static caches) and with the eager step, the graphed
              step against the read of every parameter at 3.35 TB/s,
              on granite-8b and gemma2-9b the graphed step with the
              port's head (one bf16 GEMM, fp32 result) and with the
              head widened to fp32 first, in turns, each request's
              wall time, and a torch.profiler trace of one graphed and one
              eager request (device busy share, kernel time by kind): a
              ``generate``, or on pixtral and whisper a ``vision_generate``
              / ``transcribe`` with random extras; for granite-moe and
              olmoe also
              one ``moe_apply`` alone at the prefill (4 x 512) and decode
              (4 x 1) shapes, CUDA events;
7. device_ms -- each kernel's device time a call under torch.profiler
              (``device_ms``) at phase 3's timed shapes, taken last so
              that no profiler session of it comes before phases 5 and
              6.

It prints each phase's wall time, one JSON line with an entry per kernel
and configuration (``{"kernels": [...]}``), and ends with ``{"ok": true,
"device": {...}}``.
Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): used for bound_ms
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": dict(rtol=3e-2, atol=3e-2),
       "float32": dict(rtol=2e-5, atol=2e-5)}
# decode's outputs, and those of flash with no mask, are averages over
# many keys, |o| ~ sqrt(e / n_keys) (0.036 at recurrentgemma-2b's 2048
# slots, 0.043 at whisper's 1500 frames), so their bf16 limit is held to
# the output's scale: a split of the combine read stale or left out, or
# a key tile lost, moves o by ~0.01
AVG_BF16_TOL = dict(rtol=2e-2, atol=5e-3)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
# the main paths: batch, prompt length, max_len (the cache holds max_len
# and the vision prefix), new tokens
PATHS = {"granite-8b": dict(batch=4, prefill=512, cache=640, new=16),
         # at granite-8b's shapes: 32.8 B bf16 parameters (65.5 GB of
         # the card's 80), an untied 152064-row head, G 5
         "qwen2.5-32b": dict(batch=4, prefill=512, cache=640, new=16),
         "recurrentgemma-2b": dict(batch=4, prefill=2048, cache=2064,
                                   new=16),
         "granite-moe-1b-a400m": dict(batch=4, prefill=512, cache=640,
                                      new=16),
         # 64 experts top-8, G 1 at hd 128, qk-norm
         "olmoe-1b-7b": dict(batch=4, prefill=512, cache=640, new=16),
         "pixtral-12b": dict(batch=4, prefill=512, cache=640, new=16),
         # the decoder's 448-token text context (arXiv:2212.04356)
         "whisper-large-v3": dict(batch=4, prefill=224, cache=448, new=16),
         # prompts past the local window, so the decode wraps the ring;
         # ``score`` on the prompt's first 512 tokens (at full length the
         # fp32 logits are 18.9 / 8.6 GB)
         # kv_quant: served again with that KV cache, on the same weights
         "gemma2-9b": dict(batch=4, prefill=4608, cache=4624, new=16,
                           score=512, kv_quant="int8"),
         "gemma3-27b": dict(batch=4, prefill=2048, cache=2064, new=16,
                            score=512),
         "xlstm-350m": dict(batch=4, prefill=512, cache=528, new=16)}
# the reference bench's archs and workload length
LAUNCHER_ARCHS = ("granite-moe-1b-a400m", "whisper-large-v3", "pixtral-12b",
                  "qwen2.5-32b")
N_LAUNCHER_REQUESTS = 24
# requests per entry on each main path (entries an arch lacks are skipped)
N_REQUESTS = {"generate": 3, "vision_generate": 2, "transcribe": 2,
              "score": 1}
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


def device_ms(fn, sets, match, iters=20, warmup=3):
    """Device ms per call of fn(*s), a call launching one kernel whose
    name holds ``match``: those kernels' summed torch.profiler durations
    over ``iters`` calls, over the number of them the profiler recorded
    (after an earlier session in the process it may miss some, or all:
    then up to two more sessions are taken; the count is printed); None
    if none recorded any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*sets[i % len(sets)])
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and match in ev.name]
        if us:
            break
    if len(us) != iters:
        log(f"[device_ms] the profiler recorded {len(us)} of {iters} "
            f"{match} kernels")
    return sum(us) / 1e3 / len(us) if us else None


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
        fn = "?"
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = _demangle(line.split("Function properties for")[1]
                               .strip())
            elif any(w in line for w in ("registers", "spill", "warning",
                                         "Performance Loss")):
                log(f"[build] {name}: {fn}: {line.strip()}")
    log(f"[build] {len(logs)} sources compiled in {dt:.3f} s "
        f"(into {_build.build_dir()})")
    dec = _build.load("decode_attention")
    for hd in TC_HEAD_DIMS["decode_attention"]:
        log(f"[build] decode_attention: decode_mma<{hd}> dynamic shared "
            f"memory {dec.decode_attention_mma_smem(hd)} B")
    for name in TC_HEAD_DIMS:
        check_tensor_cores(name)


# the bf16 instances that must run on the tensor cores, by library: the
# kernel symbol, the head dims, and the SASS each must hold (all of the
# first group; at least one of the second)
TC_HEAD_DIMS = {"flash_attention": (64, 128, 256),
                "decode_attention": (64, 128, 256)}
TC_SASS = {"flash_attention": (r"flash_fwd_wgmmaILi(\d+)E", ("HGMMA",),
                               ("UTMALDG",)),
           "decode_attention": (r"decode_mmaILi(\d+)E", ("HMMA",),
                                ("LDGSTS", "UTMALDG"))}
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "UBLKCP")


def _cuobjdump():
    """cuobjdump beside nvcc, else the one Triton ships."""
    import importlib.util

    from repro_torch.kernels import _build
    beside = Path(_build.nvcc()).parent / "cuobjdump"
    if beside.exists():
        return str(beside)
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        shipped = (Path(spec.origin).parent / "backends" / "nvidia" / "bin"
                   / "cuobjdump")
        if shipped.exists():
            return str(shipped)
    raise RuntimeError("cuobjdump not found (beside nvcc or in Triton)")


def sass_counts(lib):
    """{kernel symbol: {op: n for op in SASS_OPS, "max_reg": i}} from the
    library's SASS; max_reg is the highest register index used, which
    past a setmaxnreg may exceed the entry count that -Xptxas -v prints."""
    import re
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {**dict.fromkeys(SASS_OPS, 0), "max_reg": -1}
        elif fn is not None:
            n = counts[fn]
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    n[op] += 1
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b",
                                               line.split(";")[0])]
            n["max_reg"] = max([n["max_reg"], *regs])
    return counts


def check_tensor_cores(name):
    """Print each instance's tensor-core and asynchronous-copy counts in
    library ``name``; fail unless its bf16 instances at
    TC_HEAD_DIMS[name] hold what TC_SASS[name] requires."""
    import re
    from repro_torch.kernels import _build
    pattern, need_all, need_one = TC_SASS[name]
    counts = sass_counts(_build.build_dir() / f"lib{name}.so")
    found = set()
    for sym, n in sorted(counts.items()):
        ops = ", ".join(f"{op} {n[op]}" for op in SASS_OPS if n[op])
        log(f"[build] {name} SASS: {_demangle(sym)}: "
            f"{ops or 'no ' + '/'.join(SASS_OPS)}, highest register "
            f"R{n['max_reg']}")
        m = re.search(pattern, sym)
        if m and all(n[op] for op in need_all) \
                and any(n[op] for op in need_one):
            found.add(int(m.group(1)))
    want = " and ".join([*need_all, " or ".join(need_one)])
    missing = [hd for hd in TC_HEAD_DIMS[name] if hd not in found]
    if missing:
        raise RuntimeError(f"{name}: the bf16 instances at head_dim "
                           f"{missing} lack {want} in their SASS: they do "
                           "not run on the tensor cores from asynchronous "
                           "copies")
    log(f"[build] {name}: bf16 at head_dim {TC_HEAD_DIMS[name]} holds "
        f"{want}")


def _demangle(sym):
    """The kernel instance's C++ name (c++filt where the toolkit's host
    binutils have it, else the mangled symbol)."""
    import shutil
    if not shutil.which("c++filt"):
        return sym
    full = subprocess.run(["c++filt", sym], capture_output=True,
                          text=True, check=True).stdout.strip()
    return full.split("::", 1)[-1].split("(")[0]  # e.g. flash_fwd<float, 256>


# --------------------------------------------------------------- phase 3
def _rand(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _check(name, got, want, dtype_name, case, averaged=False):
    """``averaged``: every output row averages over all its keys (flash
    with no mask), as decode's do."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    averaged = averaged or name == "decode_attention"
    tol = AVG_BF16_TOL if averaged and dtype_name == "bfloat16" \
        else TOL[dtype_name]
    torch.testing.assert_close(got.float(), want.float(), **tol,
                               msg=lambda m: f"{name} {case}: {m}")
    log(f"[kernels] {name} {dtype_name} {case}: max_abs_err {err:.3e} "
        f"(rtol {tol['rtol']:g}, atol {tol['atol']:g}) ok")
    return err


def _dtypes():
    import torch
    return ((torch.bfloat16, "bfloat16"), (torch.float32, "float32"))


def _attn_shape(arch, local=True):
    """(H, K, hd, window) of the path's attention layers: its local ones
    where it has any and ``local`` is set, else its global ones."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import block_pattern_of
    cfg = get_config(arch)
    local = local and "attn_local" in block_pattern_of(cfg)
    return (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.window_size if local else None)


def _softcap(arch):
    from repro_torch.configs import get_config
    return get_config(arch).attn_softcap


def _prefill_len(arch):
    """Tokens in the path's longest prefill: the prompt and, on a vision
    path, the vision prefix."""
    from repro_torch.configs import get_config
    return PATHS[arch]["prefill"] + get_config(arch).vision_tokens


def _flex_attention():
    """``torch.compile``'d flex_attention: the one PyTorch call that
    computes attention with a softcap (SDPA has none), for ``library_ms``
    only -- the port never calls it.  Inductor and Triton compile in this
    process (no pool of workers) and cache under build/."""
    import os

    import torch
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import flex_attention
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(REPO / "build" / sub))
    inductor_config.compile_threads = 1
    return torch.compile(flex_attention, dynamic=False)


def flash_cases(gen, arch, small, *, sq=None, skv=None, causal=True,
                what="prefill", local=True):
    """Flash kernel vs plain on the card at one of the path's shapes --
    by default its longest causal prefill through its local layers where
    it has any (``local=False``: its global ones), with the path's
    softcap; ``sq``/``skv``/``causal`` name another (whisper's encoder
    and cross attention) -- and at ``small`` cases; returns the summary
    entry (timed in bf16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    B = PATHS[arch]["batch"]
    Sq = sq or _prefill_len(arch)
    Skv = skv or Sq
    H, K, hd, window = _attn_shape(arch, local)
    cap = _softcap(arch)
    G = H // K
    shape = (f"{what}: B={B} H={H} K={K} Sq={Sq} Skv={Skv} hd={hd} "
             f"window={window} softcap={cap} "
             f"{'causal' if causal else 'no mask'}")
    kw = dict(causal=causal, window=window, softcap=cap)
    main = {}

    def model_layout(dt):
        # in model layout: q (B,Sq,K,G,hd), k/v (B,Skv,K,hd), handed to
        # the kernel as transposed views, as attn_apply does
        q5 = _rand(gen, (B, Sq, K, G, hd), dt)
        k4 = _rand(gen, (B, Skv, K, hd), dt)
        v4 = _rand(gen, (B, Skv, K, hd), dt)
        return (q5.reshape(B, Sq, H, hd).transpose(1, 2),
                k4.transpose(1, 2), v4.transpose(1, 2))

    for dt, dn in _dtypes():
        args = model_layout(dt)
        got = flash_attention(*args, **kw)
        torch.cuda.synchronize()
        want = flash_attention_plain(*args, **kw)
        main[dn] = _check("flash_attention", got, want, dn, shape,
                          averaged=not causal)
        del args, got, want
        for (b, h, kk, s_q, s_kv, d, c, win, c_cap, case) in small:
            q = _rand(gen, (b, h, s_q, d), dt)
            k = _rand(gen, (b, kk, s_kv, d), dt)
            v = _rand(gen, (b, kk, s_kv, d), dt)
            ckw = dict(causal=c, window=win, softcap=c_cap)
            got = flash_attention(q, k, v, **ckw)
            torch.cuda.synchronize()
            _check("flash_attention", got, flash_attention_plain(q, k, v,
                                                                 **ckw),
                   dn, case, averaged=not c)

    # timing at the path's shape and type (bf16), cold L2
    dt = torch.bfloat16
    one = 2 * (B * Sq * H * hd + 2 * B * Skv * K * hd)

    def make_sets():
        return [model_layout(dt) for _ in range(n_sets(one))]

    sets = make_sets()
    n0 = flash_attention.launches
    ms = time_ms(lambda q, k, v: flash_attention(q, k, v, **kw), sets)
    plain_ms = time_ms(lambda q, k, v: flash_attention_plain(q, k, v, **kw),
                       sets)
    if cap is not None:
        # SDPA has no softcap: flex_attention with the softcap as its
        # score_mod and the causal window as a block mask (built once,
        # outside the timing), held to the plain version first
        from torch.nn.attention.flex_attention import create_block_mask

        def keep(b, h, qi, ki):
            m = ki <= qi
            return m & (ki > qi - window) if window is not None else m

        def capped(sc, b, h, qi, ki):
            return cap * torch.tanh(sc / cap)
        assert causal, "a softcapped path without a causal mask"
        bm = create_block_mask(keep, None, None, Sq, Skv, device="cuda")
        flex = _flex_attention()

        def lib(q, k, v):
            return flex(q, k, v, score_mod=capped, block_mask=bm,
                        enable_gqa=True)
        _check("flex_attention (library)", lib(*sets[0]),
               flash_attention_plain(*sets[0], **kw), "bfloat16", shape)
        lib_ms = time_ms(lib, sets)
    elif window is not None and window < Skv:
        # SDPA takes a sliding window only as a boolean mask
        i = torch.arange(Sq, device="cuda")[:, None]
        j = torch.arange(Skv, device="cuda")[None, :]
        mask = (j <= i) & (j > i - window)
        lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), sets)
    else:
        lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), sets)
    flash_attention.launches = n0  # timing launches are not the path's
    # the (q, k) pairs per head the mask keeps (causal: inside the window)
    pairs = (sum(min(i + 1, window or Skv) for i in range(Sq)) if causal
             else Sq * Skv)
    flops = 4 * B * H * pairs * hd  # the softcap's tanh is not counted
    byts = 2 * (2 * B * H * Sq * hd) + 2 * (2 * B * K * Skv * hd)
    return _entry("flash_attention", "flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:92", arch, shape,
                  main["bfloat16"], ms, plain_ms, lib_ms, flops, byts,
                  "bfloat16", (make_sets, lambda q, k, v: flash_attention(
                      q, k, v, **kw), "flash_fwd"))


def _filled(n, S, B):
    """Slot positions of a cache whose first n slots hold 0..n-1."""
    import torch
    base = torch.arange(S, device="cuda")
    kv = torch.where(base < n, base, -1).to(torch.int32)
    return (kv.expand(B, S).contiguous(),
            torch.full((B,), n - 1, dtype=torch.int32, device="cuda"))


def _ring(s, cur, b):
    """Slot positions of an s-slot ring after position cur: slot i holds
    the newest position p <= cur with p % s == i."""
    import torch
    base = torch.arange(s, device="cuda")
    kv = torch.where(base <= cur % s, base + (cur // s) * s,
                     base + (cur // s - 1) * s)
    return (kv.to(torch.int32).expand(b, s).contiguous(),
            torch.full((b,), cur, dtype=torch.int32, device="cuda"))


def _all_valid(S, B, q_pos):
    """Slot positions of cross attention's cache: every slot at 0 (kept
    at every decode position), the decode position ``q_pos``."""
    import torch
    return (torch.zeros((B, S), dtype=torch.int32, device="cuda"),
            torch.full((B,), q_pos, dtype=torch.int32, device="cuda"))


def decode_cases(gen, arch, timed, small, *, all_valid=(), slots=None,
                 local=True):
    """Decode kernel vs plain on the card at the path's decode shape --
    a partly filled cache (``timed="partly filled"``: mid-generation in
    a position-indexed cache), a wrapped ring (its local layers'; with
    ``local=False`` its global ones'), or with ``slots`` (the encoder's
    frames) a cache whose every slot is valid (``timed="all valid"``:
    cross attention), with the path's softcap -- and at ``small`` cases
    and ``all_valid`` ones (b, kv heads, G, S, hd, label); returns the
    summary entry for the ``timed`` one (bf16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    spec = PATHS[arch]
    H, K, hd, window = _attn_shape(arch, local)
    cap = _softcap(arch)
    G = H // K
    B = spec["batch"]
    if slots:
        S = slots
        layouts = {"all valid": _all_valid(S, B, spec["prefill"] + 8)}
    else:
        cache = spec["cache"] + get_config(arch).vision_tokens
        S = min(cache, window or cache)
        layouts = {"partly filled": _filled(_prefill_len(arch) + 8, S, B),
                   "wrapped ring": _ring(S, S + 7, B)}
    shape = f"B={B} K={K} G={G} S={S} hd={hd} window={window} softcap={cap}"
    main = {}
    for dt, dn in _dtypes():
        # main path shape: q (B,1,K,G,hd) and the per-layer cache
        # (B,S,K,hd), handed over as views, as attn_decode does
        q = _rand(gen, (B, 1, K, G, hd), dt)[:, 0]
        kc = _rand(gen, (B, S, K, hd), dt)
        vc = _rand(gen, (B, S, K, hd), dt)
        for what, (kv, qp) in layouts.items():
            if what == "partly filled" and timed != what:
                continue  # a local ring is never partly filled mid-path
            args = (q, kc.transpose(1, 2), vc.transpose(1, 2), qp, kv)
            got = decode_attention(*args, window=window, softcap=cap)
            torch.cuda.synchronize()
            err = _check("decode_attention", got,
                         decode_attention_plain(*args, window=window,
                                                softcap=cap), dn,
                         f"{shape} {what}")
            if what == timed:
                main[dn] = err
        for (b, kk, g, s, d, win, c_cap, what) in small:
            qs = _rand(gen, (b, kk, g, d), dt)
            ks = _rand(gen, (b, kk, s, d), dt)
            vs = _rand(gen, (b, kk, s, d), dt)
            if win:
                kv, qp = _ring(s, s + 7, b)
            else:
                kvb = torch.arange(s, device="cuda")
                kv = torch.where(kvb < s - 5, kvb, -1).to(
                    torch.int32).expand(b, s).contiguous()
                qp = torch.full((b,), s - 6, dtype=torch.int32,
                                device="cuda")
            kw = dict(window=win, softcap=c_cap)
            got = decode_attention(qs, ks, vs, qp, kv, **kw)
            torch.cuda.synchronize()
            _check("decode_attention", got,
                   decode_attention_plain(qs, ks, vs, qp, kv, **kw), dn,
                   what)
        for (b, kk, g, s, d, what) in all_valid:
            kv, qp = _all_valid(s, b, 3)
            args = (_rand(gen, (b, kk, g, d), dt),
                    _rand(gen, (b, kk, s, d), dt),
                    _rand(gen, (b, kk, s, d), dt), qp, kv)
            got = decode_attention(*args)
            torch.cuda.synchronize()
            _check("decode_attention", got, decode_attention_plain(*args),
                   dn, what)

    dt = torch.bfloat16
    kv, qp = layouts[timed]
    one = 2 * B * S * K * hd * 2

    def make_sets():
        sets = []
        for _ in range(n_sets(one)):
            q = _rand(gen, (B, 1, K, G, hd), dt)[:, 0]
            kc = _rand(gen, (B, S, K, hd), dt)
            vc = _rand(gen, (B, S, K, hd), dt)
            sets.append((q, kc.transpose(1, 2), vc.transpose(1, 2)))
        return sets

    sets = make_sets()
    mask = (kv >= 0) & (kv <= qp[:, None])  # (B, S)
    if window is not None:
        mask &= kv > qp[:, None] - window
    n0 = decode_attention.launches
    ms = time_ms(lambda q, k, v: decode_attention(
        q, k, v, qp, kv, window=window, softcap=cap), sets)
    plain_ms = time_ms(lambda q, k, v: decode_attention_plain(
        q, k, v, qp, kv, window=window, softcap=cap), sets)
    if cap is None:
        lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q.reshape(B, K * G, 1, hd), k, v, attn_mask=mask[:, None, None],
            enable_gqa=True), sets)
    else:
        # SDPA has no softcap: flex_attention with the softcap and the
        # slot mask (from kv_pos and q_pos, as the kernel reads them) in
        # its score_mod, so that the one call takes the kernel's inputs;
        # held to the plain version first
        def capped(sc, b, h, qi, ki):
            p, at = kv[b, ki], qp[b]
            ok = (p >= 0) & (p <= at)
            if window is not None:
                ok = ok & (p > at - window)
            return torch.where(ok, cap * torch.tanh(sc / cap), -math.inf)
        flex = _flex_attention()

        def lib(q, k, v):
            return flex(q.reshape(B, K * G, 1, hd), k, v, score_mod=capped,
                        enable_gqa=True).reshape(B, K, G, hd)
        _check("flex_attention (library)", lib(*sets[0]),
               decode_attention_plain(*sets[0], qp, kv, window=window,
                                      softcap=cap),
               "bfloat16", f"{shape} {timed}", averaged=True)
        lib_ms = time_ms(lib, sets)
    decode_attention.launches = n0
    # what this run's data needs: k and v of the valid slots, every slot
    # position, q and o
    n_valid = int(mask.sum())  # over the batch
    flops = 4 * K * G * n_valid * hd
    byts = 2 * (2 * K * n_valid * hd) + 4 * B * S + 4 * B \
        + 2 * (2 * B * K * G * hd)
    return _entry("decode_attention", "decode_attention.cu",
                  "src/repro/kernels/decode_attention.py:70", arch,
                  f"{shape} {timed}", main["bfloat16"], ms, plain_ms,
                  lib_ms, flops, byts, "bfloat16",
                  (make_sets, lambda q, k, v: decode_attention(
                      q, k, v, qp, kv, window=window, softcap=cap),
                   "decode_"))


def rglru_cases(gen, arch):
    """RG-LRU scan kernel vs plain on the card at the path's prefill
    shape (fp32, as the model passes it, and bf16) and at the reference's
    small ragged cases; returns the summary entry (timed in fp32)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
    spec = PATHS[arch]
    B, S, R = spec["batch"], spec["prefill"], get_config(arch).rglru_dim
    shape = f"B={B} S={S} R={R}"
    main = {}
    for dt, dn in _dtypes():
        cases = [(B, S, R, False, shape), (2, 64, 128, False, "B=2 S=64"),
                 (1, 40, 130, True, "ragged R=130, h0"),
                 (2, 17, 64, True, "ragged S=17, h0"),
                 (2, 1, 64, True, "S=1, h0"),
                 (1, 37, 2560, False, "S=37 (not a multiple of 32 steps)"),
                 (2, 50, 33, True, "R=33 (a part of a 64-channel block), h0")]
        for b, s, r, with_h0, what in cases:
            # decays in (0, 1) like real RG-LRU coefficients
            a = torch.sigmoid(_rand(gen, (b, s, r), torch.float32)).to(dt)
            x = _rand(gen, (b, s, r), dt)
            h0 = _rand(gen, (b, r), dt) if with_h0 else None
            got = rglru_scan(a, x, h0)
            torch.cuda.synchronize()
            err = _check("rglru_scan", got, rglru_scan_plain(a, x, h0), dn,
                         what)
            if what == shape:
                main[dn] = err

    dt = torch.float32
    one = 3 * B * S * R * 4

    def make_sets():
        return [(torch.sigmoid(_rand(gen, (B, S, R), dt)),
                 _rand(gen, (B, S, R), dt)) for _ in range(n_sets(one))]

    sets = make_sets()
    n0 = rglru_scan.launches
    ms = time_ms(rglru_scan, sets)
    plain_ms = time_ms(rglru_scan_plain, sets, iters=5, warmup=1)
    # a yardstick of the rate a plain stream over the same bytes reaches
    # (a and b read once, one output written): not the same function
    outs = [torch.empty_like(a) for a, _ in sets]
    k = iter(range(1 << 30))
    stream_ms = time_ms(lambda a, b: torch.mul(
        a, b, out=outs[next(k) % len(outs)]), sets)
    log(f"[kernels] rglru_scan {arch} yardstick: torch.mul over the same "
        f"bytes {stream_ms:.4f} ms")
    rglru_scan.launches = n0
    # one multiply-add per element; a and b read once, h written once
    flops = 2 * B * S * R
    byts = 3 * B * S * R * 4
    return _entry("rglru_scan", "rglru_scan.cu",
                  "src/repro/kernels/rglru_scan.py:45", arch, shape,
                  main["float32"], ms, plain_ms, None, flops, byts,
                  "float32", (make_sets, rglru_scan, "rglru_"))


def _entry(name, src, replaces, arch, shape, err, ms, plain_ms, lib_ms,
           flops, byts, dtype_name, device_timing):
    """The kernel's summary entry; ``device_timing`` is (make_sets, fn,
    kernel name match) for phase 7, which fills ``device_ms``."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = byts / PEAK_BYTES_S * 1e3
    e = {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}",
         "replaces": replaces, "launches": 0, "max_abs_err": err,
         "ms": ms, "device_ms": None, "plain_ms": plain_ms,
         "bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops > t_bytes else "bytes",
         "library_ms": lib_ms, "path": arch,
         "shape": f"{shape} {dtype_name}", "_device_timing": device_timing}
    lib = "none (no single PyTorch call computes it)" if lib_ms is None \
        else f"{lib_ms:.4f} ms"
    log(f"[kernels] {name} {arch} {dtype_name} timing: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {lib}, bound "
        f"{e['bound_ms']:.4f} ms ({e['bound_by']}: {flops:.4g} flop, "
        f"{byts:.4g} B)")
    return e


# --------------------------------------------------------------- phase 7
def phase_device_time(entries):
    """Each kernel's device time a call under torch.profiler, on fresh
    inputs of its timed shape; run after the serving phases, so that no
    profiler session precedes their host-clock timings."""
    counters = _kernel_counters()
    for e in entries:
        make_sets, fn, match = e.pop("_device_timing")
        counter = counters[e["name"]]
        n0 = counter.launches
        e["device_ms"] = device_ms(fn, make_sets(), match)
        counter.launches = n0
        dev = "not measured" if e["device_ms"] is None \
            else f"{e['device_ms']:.4f} ms"
        log(f"[device_ms] {e['name']} {e['path']}: device {dev} a call "
            f"(events: {e['ms']:.4f} ms)")


# --------------------------------------------------------------- phase 4
def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _random_extras(cfg, B, rng, entry=None):
    """The config's frontend inputs from ``rng`` (float32 numpy):
    patch embeddings on a vision config, encoder frames on an audio one;
    with ``entry``, only the extras that entry takes."""
    out = {}
    if cfg.vision_tokens and entry in (None, "vision_generate"):
        out["patch_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model), dtype=np.float32)
    if cfg.encoder_layers and entry in (None, "transcribe"):
        out["enc_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return out


def phase_parity(arch, n_dec, **cfg_kw):
    """The reduced config (with ``cfg_kw`` changes) in fp32, CUDA
    (kernels) against CPU (plain), with random patch embeddings / encoder
    frames where the config takes them: prefill logits, the encoder's
    output, every cache leaf after the prefill and after the last of
    ``n_dec`` decode steps, and every step's logits."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    cfg = get_reduced(arch).with_(**cfg_kw)
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")

    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}
    params_gpu = to_cuda(params)
    B, T0, vt = 2, 8, cfg.vision_tokens
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, T0 + n_dec)).astype(np.int32))
    ex = {k: torch.from_numpy(v)
          for k, v in _random_extras(cfg, B, rng).items()}
    ex_gpu = {k: v.cuda() for k, v in ex.items()}
    lc, cc, ac = M.prefill(cfg, params, toks[:, :T0],
                           cache_len=vt + T0 + n_dec, **ex)
    lg, cg, ag = M.prefill(cfg, params_gpu, toks[:, :T0].cuda(),
                           cache_len=vt + T0 + n_dec, **ex_gpu)
    errs = [_close(lg, lc, "prefill logits")]
    if cfg.encoder_layers:
        errs.append(_close(M.run_encoder(cfg, params_gpu, ex_gpu[
            "enc_frames"]), M.run_encoder(cfg, params, ex["enc_frames"]),
            "encoder output"))
    if ag.keys() != ac.keys():
        raise RuntimeError(f"parity aux keys {sorted(ag)} != {sorted(ac)}")
    for name in ac:  # MoE: router load and load-balancing loss
        errs.append(_close(ag[name], ac[name], f"prefill aux {name}"))
    want = dict(_leaves(cc))
    for name, got in _leaves(cg):
        errs.append(_close(got, want[name], f"prefill cache {name}"))
    for i in range(n_dec):
        pos = torch.full((B,), vt + T0 + i, dtype=torch.int32)
        tok = toks[:, T0 + i:T0 + i + 1]
        lc, cc = M.decode_step(cfg, params, tok, pos, cc)
        lg, cg = M.decode_step(cfg, params_gpu, tok.cuda(), pos.cuda(), cg)
        errs.append(_close(lg, lc, f"decode step {i} logits"))
    want = dict(_leaves(cc))
    for name, got in _leaves(cg):
        errs.append(_close(got, want[name], f"decoded cache {name}"))
    log(f"[parity] {arch} {cfg_kw or ''} reduced fp32, CUDA kernels vs "
        f"CPU plain: "
        f"{len(want)} cache leaves, aux {sorted(ac)}, extras {sorted(ex)}, "
        f"{n_dec} decode steps to position {vt + T0 + n_dec - 1} (window "
        f"{cfg.window_size}, {cfg.encoder_seq} encoder frames): max abs "
        f"err {max(errs):.3e} (tolerance 2e-3) ok")


def _close(got, want, what):
    """Max abs difference, held to MODEL_TOL; int8 KV codes to one step
    (a value on a rounding boundary may land either side)."""
    import torch
    got, want = got.cpu(), want.cpu()
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.int8:
        if want.dtype != torch.int8 or err > 1:
            raise RuntimeError(f"parity {what}: int8 codes differ by {err}")
        if err:
            log(f"[parity] {what}: int8 codes differ by one step")
        return 0.0  # codes, not values: kept out of the logged max
    torch.testing.assert_close(got, want, **MODEL_TOL,
                               msg=lambda m: f"parity {what}: {m}")
    return err


# -------------------------------------------------------------- phase 4b
# gradient tolerance, CUDA against CPU: a leaf within GRAD_RTOL of its
# largest magnitude plus GRAD_ATOL (tests/test_training.py's); the two
# reduced configs whose fp32 gradients sit on a measured noise floor get
# the wider bounds of tests/test_torch_grads.py, for the reasons stated
# there (recurrentgemma's saturated RG-LRU gates, whisper's encoder
# gradients through cross attention)
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
GRAD_RTOL_ARCH = {"recurrentgemma-2b": 1e-2, "whisper-large-v3": 1e-3}
# phase 4b: B x S of the reduced batch; loss_chunk 512 at B 2 gives
# sequence chunks of 256, so the chunked, checkpointed CE runs
GRAD_B, GRAD_S, GRAD_LOSS_CHUNK = 2, 512, 512


def _train_launches(cfg):
    """Kernel launches of one train step (one microbatch) under
    ``cfg.remat``: flash once per attention, cross-attention and encoder
    layer in the forward and once more in the remat recompute;
    rglru_scan once forward, once recomputed and once in the backward
    (the reverse-time scan) per RG-LRU layer; no decode."""
    per = _per_call(cfg)
    fwd = 2 if cfg.remat == "block" else 1
    return {"flash_attention": per["flash_attention"] * fwd,
            "decode_attention": 0,
            "rglru_scan": per["rglru_scan"] * (fwd + 1)}


def _train_batch(cfg, B, S, seed):
    """tokens and labels (-1 at one place), with random frames on an
    audio config, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][0, 5] = -1
    batch.update(_random_extras(cfg, B, rng))
    return batch


def _grad_step(cfg, params, batch):
    """One make_train_step on ``params``' device: (metrics, the grads
    the step handed to AdamW, the updated params, the AdamW state)."""
    import torch
    from repro_torch.training.adamw import adamw_init
    from repro_torch.training.step import make_train_step
    seen = []

    def keep(grads):
        seen.append(grads)
        return grads
    step = make_train_step(cfg, lr=1e-3, compress_fn=keep)
    dev = next(iter(_leaves(params)))[1].device
    opt = adamw_init(params)
    params, opt, metrics = step(params, opt, {
        k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    return metrics, seen[0], params, opt


def phase_grad_parity(arch):
    """The reduced config in fp32 with ``remat == "block"``, one train
    step on the card (kernel forwards, the autograd Functions'
    backwards) against the same step on the CPU (plain versions) from
    the same params and batch: the loss and metrics, every gradient leaf
    (tolerance above), the launches, and one checkpoint round trip of
    the card's (params, AdamW state), bit for bit."""
    import tempfile

    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    from repro_torch.training.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.tree import tree_leaves, tree_map
    cfg = get_reduced(arch).with_(loss_chunk=GRAD_LOSS_CHUNK)
    assert cfg.remat == "block"
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    params_gpu = tree_map(lambda t: t.cuda(), params)
    batch = _train_batch(cfg, GRAD_B, GRAD_S, 4)
    mc, grads_cpu, _, _ = _grad_step(cfg, params, batch)
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    mg, gg, params_gpu, opt_gpu = _grad_step(cfg, params_gpu, batch)
    torch.cuda.synchronize()
    got = {name: fn.launches for name, fn in counters.items()}
    want = _train_launches(cfg)
    if got != want:
        raise RuntimeError(f"grad parity {arch}: launches {got}, want "
                           f"{want}")
    if mg.keys() != mc.keys():
        raise RuntimeError(f"grad parity {arch}: metrics {sorted(mg)} != "
                           f"{sorted(mc)}")
    rtol = GRAD_RTOL_ARCH.get(arch, GRAD_RTOL)
    worst = 0.0
    for what, g_tree, c_tree in (("metric", mg, mc),
                                 ("grad", gg, grads_cpu)):
        g_leaves = dict(_leaves(g_tree))
        for name, c in _leaves(c_tree):
            g = g_leaves[name].float().cpu()
            c = c.float()
            err = (g - c).abs().max().item()
            bound = rtol * c.abs().max().item() + GRAD_ATOL
            worst = max(worst, err / bound)
            if not err <= bound:
                raise RuntimeError(f"grad parity {arch}: {what} {name} max "
                                   f"err {err:.3e} > {bound:.3e}")
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        save_checkpoint(d, 1, (params_gpu, opt_gpu))
        back, _ = restore_checkpoint(d, 1, tree_map(torch.empty_like,
                                                    (params_gpu, opt_gpu)))
    for a, b in zip(tree_leaves((params_gpu, opt_gpu)), tree_leaves(back)):
        if a.device != b.device or a.dtype != b.dtype or \
                not torch.equal(a, b):
            raise RuntimeError(f"grad parity {arch}: checkpoint round trip "
                               "changed a leaf")
    log(f"[grad] {arch} reduced fp32 B {GRAD_B} S {GRAD_S} loss_chunk "
        f"{GRAD_LOSS_CHUNK} remat block: loss cuda {float(mg['loss']):.6f} "
        f"cpu {float(mc['loss']):.6f}; {len(list(_leaves(grads_cpu)))} grad "
        f"leaves, worst err / bound {worst:.3f} (rtol {rtol:g}, atol "
        f"{GRAD_ATOL:g}); launches {got} ok; checkpoint of "
        f"{len(tree_leaves((params_gpu, opt_gpu)))} CUDA leaves restored "
        f"bit for bit")


def phase_flash_grad(B=1, H=32, K=8, S=4096, hd=128, chunk=1024):
    """granite-8b's training attention in bf16: flash_attention_fn's
    grads (kernel forward, the plain chunked backward) against autograd
    through flash_attention_plain, 3e-2."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_fn, flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = _rand(gen, (B, H, S, hd), torch.bfloat16)
    k = _rand(gen, (B, K, S, hd), torch.bfloat16)
    v = _rand(gen, (B, K, S, hd), torch.bfloat16)
    do = _rand(gen, (B, H, S, hd), torch.bfloat16)
    n0 = flash_attention.launches
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention_fn(*ins, chunk=chunk), ins, do)
    flash_attention.launches = n0
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ins), ins, do)
    errs = []
    for name, a, b in zip("qkv", got, want):
        errs.append((a.float() - b.float()).abs().max().item())
        torch.testing.assert_close(a.float(), b.float(), rtol=3e-2,
                                   atol=3e-2,
                                   msg=lambda m: f"flash grad d{name}: {m}")
    log(f"[grad] flash_attention_fn bf16 B {B} H {H} K {K} S {S} hd {hd} "
        f"causal, backward chunk {chunk}: dq/dk/dv max abs err "
        f"{', '.join(f'{e:.3e}' for e in errs)} against autograd through "
        f"the plain version (3e-2) ok")


# -------------------------------------------------------------- phase 4c
# the meshed runs held on this machine's torch: the MoE dispatch served,
# the xLSTM scans' sequence-parallel gradients
MESH4_SERVE = ("granite-moe-1b-a400m", "olmoe-1b-7b")
MESH4_GRAD = ("xlstm-350m",)
MESH4_B, MESH4_S, MESH4_DEC = 4, 16, 2


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _serve_steps(cfg, params, tok, n_dec, place):
    """A prefill and ``n_dec`` greedy decode steps; ``place(t, n_extra)``
    puts an input where the run needs it.  Each step's whole logits as
    numpy (n_dec + 1, B, V)."""
    import torch
    from repro_torch.models import model as M
    out = []
    lg, caches, _ = M.prefill(cfg, params, place(tok, 1),
                              cache_len=tok.shape[1] + n_dec + 2)
    for i in range(n_dec + 1):
        whole = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
        out.append(whole.numpy())
        if i == n_dec:
            break
        nxt = whole.argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((tok.shape[0],), tok.shape[1] + i,
                         dtype=torch.int32)
        lg, caches = M.decode_step(cfg, params, place(nxt, 1),
                                   place(pos, 0), caches)
    return np.stack(out)


def _mesh_rank(rank, world, port, out_dir):
    """One of the four gloo ranks of phase 4c (CPU tensors): each arch's
    reduced fp32 config unmeshed and on the (2, 2) mesh; rank 0 saves
    both into ``out_dir``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import (
        batch_pspec, distribute_params, distribute_tree)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models.partition import use_act_mode, use_mesh
    from repro_torch.training.tree import tree_leaves, tree_unflatten
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        B, S = MESH4_B, MESH4_S

        def place(t, n):
            return distribute_tree({"t": t}, {"t": batch_pspec(
                mesh, batch_size=B, extra_dims=n)}, mesh)["t"]
        for arch in MESH4_SERVE:
            cfg = get_reduced(arch).with_(dtype="float32")
            params = M.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
            tok = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab, (B, S)).astype(np.int32))
            with torch.no_grad():
                want = _serve_steps(cfg, params, tok, MESH4_DEC,
                                    lambda t, n: t)
                dparams = distribute_params(params, cfg, mesh)
                with use_mesh(mesh):
                    got = _serve_steps(cfg, dparams, tok, MESH4_DEC, place)
            if rank == 0:
                np.savez(Path(out_dir) / f"serve-{arch}.npz", want=want,
                         got=got)
        for arch in MESH4_GRAD:
            cfg = get_reduced(arch).with_(dtype="float32")
            params = M.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
            tok = torch.from_numpy(np.random.default_rng(2).integers(
                0, cfg.vocab, (B, S)).astype(np.int32))
            batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}

            def grads(p, b):
                leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
                loss, _ = M.loss_fn(cfg, tree_unflatten(p, leaves), b)
                return [loss] + list(torch.autograd.grad(loss, leaves))
            want = grads(params, batch)
            dparams = distribute_params(params, cfg, mesh)
            dbatch = {k: place(v, 1) for k, v in batch.items()}
            with use_mesh(mesh), use_act_mode("sp"):
                got = [g.full_tensor() for g in grads(dparams, dbatch)]
            if rank == 0:
                np.savez(Path(out_dir) / f"grad-{arch}.npz",
                         *[g.detach().numpy() for g in got],
                         *[w.detach().numpy() for w in want])
    finally:
        dist.destroy_process_group()


def phase_mesh_torch():
    """Four gloo ranks on this machine's CPU, a (2, 2) ("data", "model")
    mesh, on the torch installed here: the reduced MoE configs served
    (fp32, B 4 x S 16, a prefill and 2 decode steps) and reduced
    xlstm-350m's "sp" loss and gradients, each against the unmeshed port
    on the same weights -- logits within 2e-3 of their scale with
    identical greedy tokens; the loss and every gradient leaf within 1e-5
    of its scale plus 1e-7.  A rank's exception fails the phase."""
    import tempfile

    import torch
    import torch.multiprocessing as tmp
    log(f"[mesh4] torch {torch.__version__}: 4 gloo ranks, (2, 2) "
        f"('data', 'model') mesh on the CPU; serve {list(MESH4_SERVE)}, "
        f"'sp' gradients {list(MESH4_GRAD)}")
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as out:
        tmp.spawn(_mesh_rank, args=(4, _free_port(), out), nprocs=4,
                  join=True)
        for arch in MESH4_SERVE:
            r = np.load(Path(out) / f"serve-{arch}.npz")
            want, got = r["want"], r["got"]
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            same = bool((got.argmax(-1) == want.argmax(-1)).all())
            log(f"[mesh4] {arch} reduced fp32 served meshed vs unmeshed: "
                f"{MESH4_DEC} decode steps, logits max abs diff / max abs "
                f"{rel:.3e} (limit 2e-3), greedy tokens identical {same}")
            if got.shape != want.shape or not rel < 2e-3 or not same:
                raise RuntimeError(f"mesh4 {arch}: the meshed serve differs")
        for arch in MESH4_GRAD:
            r = np.load(Path(out) / f"grad-{arch}.npz")
            arrs = [r[f"arr_{i}"] for i in range(len(r.files))]
            got, want = arrs[:len(arrs) // 2], arrs[len(arrs) // 2:]
            # each leaf's difference over its limit (the loss: 1e-5 of it)
            share = [float(abs(got[0] - want[0]) / (1e-5 * abs(want[0])))]
            share += [float(np.abs(g - w).max()
                            / (1e-5 * np.abs(w).max() + 1e-7))
                      for g, w in zip(got[1:], want[1:])]
            log(f"[mesh4] {arch} reduced fp32 'sp' loss {float(got[0]):.6f} "
                f"(unmeshed {float(want[0]):.6f}) and {len(got) - 1} "
                f"gradient leaves: worst difference {max(share):.3e} of "
                f"its limit")
            if not max(share) <= 1:
                raise RuntimeError(f"mesh4 {arch}: the meshed gradients "
                                   "differ")


# --------------------------------------------------------------- phase 5
def _kernel_counters():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention, "rglru_scan": rglru_scan}


def _per_call(cfg):
    """Kernel launches of one call, from the config's layers: flash and
    rglru_scan in a prefill or forward (flash once per attention layer,
    cross-attention layer and encoder layer), decode in a decode step
    (once per attention and cross-attention layer, but for the global
    layers of an int8 KV cache, which decode in plain PyTorch).  mLSTM
    and sLSTM blocks launch none."""
    from repro_torch.models import model as M
    pat, n_per, n_rem = M.layer_layout(cfg)
    kinds = list(pat) * n_per + list(pat[:n_rem])
    n_attn = sum(k.startswith("attn") for k in kinds)
    n_quant = kinds.count("attn_global") if cfg.kv_quant == "int8" else 0
    n_cross = len(kinds) if cfg.encoder_layers else 0
    return {"flash_attention": n_attn + n_cross + cfg.encoder_layers,
            "decode_attention": n_attn - n_quant + n_cross,
            "rglru_scan": kinds.count("rglru")}


def _want(cfg, forwards, steps):
    """Launches of ``forwards`` prefills or forwards and ``steps`` decode
    steps."""
    per = _per_call(cfg)
    return {"flash_attention": per["flash_attention"] * forwards,
            "decode_attention": per["decode_attention"] * steps,
            "rglru_scan": per["rglru_scan"] * forwards}


def phase_serve(arch, entries):
    """Drive one main path, every entry of the engine; fills the
    launches of its ``entries``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine
    cfg = get_config(arch)
    spec = PATHS[arch]
    B, P, CACHE, NEW = (spec["batch"], spec["prefill"], spec["cache"],
                        spec["new"])
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, batch_size=B, prefill_len=P, max_len=CACHE,
                        device="cuda")
    cold = eng.cold_start()
    rep = eng.report()
    requests = [e for e in eng.entries() for _ in range(N_REQUESTS[e])]
    enc = (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers
           else "")
    log(f"[serve] {arch} full width: {cfg.n_layers} layers{enc}, d_model "
        f"{cfg.d_model}, {M.param_count(cfg)} params "
        f"({cfg.dtype}); batch {B}, prompt {P} (score "
        f"{spec.get('score', P)}), max_len {CACHE} (+ "
        f"{cfg.vision_tokens} vision slots), {NEW} new tokens; requests "
        f"{requests}")
    log(f"[serve] {arch} cold_start_s {cold:.4f} by_group "
        f"{rep['by_group']} (compile includes each decode graph's "
        f"capture)")
    for row in rep["components"]:
        log(f"[serve]   {row['component']}: init_s {row['init_s']}")
    for entry in eng.entries():
        graph = eng.registry[f"compile.{entry}"].value.get("graph")
        if entry != "score":
            if graph is None:
                raise RuntimeError(f"{arch} {entry}: no decode graph")
            log(f"[serve]   compile.{entry}: decode graph warm-up + "
                f"capture {graph.capture_s:.4f} s, "
                f"{graph.launches()['decode_attention']} decode launches "
                f"a replay; static caches {_nbytes(graph.caches) / 1e9:.4f}"
                f" GB")

    counters = _kernel_counters()
    rng = np.random.default_rng(7)
    SCORE = spec.get("score", P)
    # the requests' inputs are drawn before the counters are set to 0
    inputs = [(e, rng.integers(0, cfg.vocab, (B, SCORE if e == "score"
                                              else P)),
               _random_extras(cfg, B, rng, e)) for e in requests]
    for fn in counters.values():
        fn.launches = 0
    lat, outs = {}, []
    for entry, toks, extras in inputs:
        out, dt = eng.serve(entry, toks, max_new_tokens=NEW, extras=extras)
        lat.setdefault(entry, []).append(dt)
        outs.append((entry, toks, out))
    got = {name: fn.launches for name, fn in counters.items()}

    n_gen = sum(e != "score" for e in requests)
    want = _want(cfg, len(requests), (NEW - 1) * n_gen)
    log(f"[serve] {arch} launches {got} (want {want}: per prefill or "
        f"forward / decode step {_per_call(cfg)}, x {len(requests)} "
        f"requests / {NEW - 1} steps x {n_gen} generating requests)")
    if got != want:
        raise RuntimeError(f"{arch}: the main path did not run through the "
                           "kernels as expected")
    for entry, toks, out in outs:
        if entry == "score":
            if out.shape != (B, SCORE, cfg.vocab) \
                    or not np.isfinite(out).all():
                raise RuntimeError("score: logits not finite / wrong shape")
        elif out.shape != (B, NEW) or out.min() < 0 \
                or out.max() >= cfg.vocab:
            raise RuntimeError(f"{entry}: bad tokens {out.shape}")
    log(f"[serve] {arch} latency_s "
        f"{ {e: [round(x, 4) for x in v] for e, v in lat.items()} }")
    log(f"[serve] {arch} max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if cfg.moe is not None:
        log_experts(f"[serve] {arch}", eng.report())
    for entry in eng.entries():
        first = next(o for e, _, o in outs if e == entry)
        if entry != "score":
            log(f"[serve] {arch} first {entry} tokens[0]: "
                f"{first[0].tolist()}")
    outs = [o for o in outs if o[0] != "score"]  # free the logits

    # for information: full-width prefill+decode logits against the
    # teacher-forced forward over the same tokens (bf16 model)
    _, toks, out = outs[0]
    seq = np.concatenate([toks, out[:, :-1]], axis=1)
    params = eng._params
    t = torch.as_tensor(seq, dtype=torch.int32, device="cuda")
    h, _, _ = M.forward(cfg, params, t)
    full = M._head(cfg, params, h[:, P - 1:])
    del h
    lg, caches, _ = M.prefill(cfg, params, t[:, :P], cache_len=CACHE)
    steps = [lg]
    for i in range(NEW - 1):
        pos = torch.full((B,), P + i, dtype=torch.int32, device="cuda")
        lg, caches = M.decode_step(cfg, params, t[:, P + i:P + i + 1], pos,
                                   caches)
        steps.append(lg)
    inc = torch.stack(steps, dim=1)
    rel = ((inc - full).abs().max() / full.abs().max()).item()
    log(f"[serve] {arch} info: prefill+decode vs teacher-forced forward "
        f"over {seq.shape[1]} tokens, logits max abs diff / max abs = "
        f"{rel:.3e} ({cfg.dtype})")
    for e in entries:
        e["launches"] = got[e["name"]]
    counts = {name: fn.launches for name, fn in counters.items()}
    for entry in eng.entries():
        if entry != "score":
            check_graph_vs_eager(eng, entry, rng)
    for name, fn in counters.items():  # the checks are not the path's
        fn.launches = counts[name]
    return eng


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree))


def _global_bytes(cfg, caches):
    """Bytes of the cache's global attention layers."""
    from repro_torch.models import model as M
    return sum(_nbytes(caches[group][f"pos{i}"])
               for group, pattern, _ in M._groups(cfg)
               for i, kind in enumerate(pattern) if kind == "attn_global")


def phase_kv_quant(eng):
    """The path's config with its ``kv_quant`` KV cache (int8: the global
    layers' k and v as int8 codes with fp32 scales), served on the bf16
    engine's parameters (no second init; ``score`` left lazy and
    unbuilt): the caches' bytes beside the bf16 engine's, the launches of
    3 ``generate`` requests (decode only from the local layers: the
    global ones decode in plain PyTorch), the share of greedy tokens
    that agree with the bf16 engine's on the same requests, the int8
    engine's breakdown (phase 6, beside the bf16 one just before it) and
    its graph against its eager step."""
    import gc

    import torch
    from repro_torch.serving import LoadPolicy, ServingEngine
    spec = PATHS[eng.cfg.name]
    B, P, CACHE, NEW = (spec["batch"], spec["prefill"], spec["cache"],
                        spec["new"])
    cfg = eng.cfg.with_(kv_quant=spec["kv_quant"])
    params = eng._params
    q8 = ServingEngine(cfg, policy=LoadPolicy(
        lazy_names=frozenset({"compile.score"})), batch_size=B,
        prefill_len=P, max_len=CACHE, device="cuda")
    q8.registry["weights.core"].build = lambda: params
    cold = q8.cold_start()
    caches = {name: e.registry["compile.generate"].value["graph"].caches
              for name, e in (("bf16", eng), ("int8", q8))}
    log(f"[int8] {cfg.name} kv_quant {cfg.kv_quant} on the bf16 engine's weights: "
        f"cold_start_s {cold:.4f}; decode graph caches "
        + ", ".join(f"{n} {_nbytes(c) / 1e9:.4f} GB (global layers "
                    f"{_global_bytes(cfg, c) / 1e9:.4f} GB)"
                    for n, c in caches.items()))
    counters = _kernel_counters()
    rng = np.random.default_rng(17)
    reqs = [rng.integers(0, cfg.vocab, (B, P)) for _ in range(3)]
    for fn in counters.values():
        fn.launches = 0
    outs8 = [q8.serve("generate", t, max_new_tokens=NEW)[0] for t in reqs]
    got = {n: fn.launches for n, fn in counters.items()}
    want = _want(cfg, len(reqs), (NEW - 1) * len(reqs))
    log(f"[int8] {cfg.name} launches {got} (want {want}: per prefill / "
        f"decode step {_per_call(cfg)})")
    if got != want:
        raise RuntimeError(f"int8: launches {got}, want {want}")
    counts = dict(got)
    outs16 = [eng.serve("generate", t, max_new_tokens=NEW)[0] for t in reqs]
    agree = float(np.mean([np.mean(a == b) for a, b in zip(outs8, outs16)]))
    log(f"[int8] {cfg.name} greedy tokens agreeing with the bf16 cache's: "
        f"{agree:.4f} of {len(reqs) * B * NEW}; int8 tokens[0] "
        f"{outs8[0][0].tolist()}")
    phase_breakdown(q8)
    check_graph_vs_eager(q8, "generate", rng)
    for name, fn in counters.items():  # the comparisons are not the path's
        fn.launches = counts[name]
    for comp in q8.registry.values():
        comp.drop()
    del q8, caches
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def check_graph_vs_eager(eng, entry, rng):
    """The entry's decode graph against the same engine's eager decode
    step on the same prefill (one into the graph's static caches, one
    into a fresh cache tree), over the path's 15 decode steps: logits
    within MODEL_TOL (atol held to the logits' scale) and identical
    greedy tokens."""
    import torch
    from repro_torch.models import model as M
    cfg, B, spec = eng.cfg, eng.B, PATHS[eng.cfg.name]
    P, NEW = spec["prefill"], spec["new"]
    graph = eng.registry[f"compile.{entry}"].value["graph"]
    params = eng._params
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                           dtype=torch.int32, device="cuda")
    extra = eng._extras(entry, _random_extras(cfg, B, rng, entry))
    cache_len = eng.max_len + cfg.vision_tokens
    lg, _, _ = M.prefill(cfg, params, toks, cache_len=cache_len,
                         caches=graph.caches, **extra)
    le, eager, _ = M.prefill(cfg, params, toks, cache_len=cache_len,
                             **extra)
    tok_g = tok_e = lg.argmax(-1).to(torch.int32)[:, None]
    pos0 = eng._pos0(entry, P)
    worst = 0.0
    for i in range(NEW - 1):
        tok_g, lg = graph(tok_g, pos0 + i)
        pos = torch.full((B,), pos0 + i, dtype=torch.int32, device="cuda")
        le, eager = M.decode_step(cfg, params, tok_e, pos, eager)
        tok_e = le.argmax(-1).to(torch.int32)[:, None]
        scale = le.abs().max().item()
        err = (lg - le).abs().max().item()
        worst = max(worst, err / scale)
        torch.testing.assert_close(
            lg, le, rtol=MODEL_TOL["rtol"], atol=MODEL_TOL["atol"] * scale,
            msg=lambda m: f"{cfg.name} {entry} graph vs eager step {i}: {m}")
        if not torch.equal(tok_g, tok_e):
            raise RuntimeError(
                f"{cfg.name} {entry}: greedy tokens differ at decode step "
                f"{i}: graph {tok_g[:, 0].tolist()}, eager "
                f"{tok_e[:, 0].tolist()}")
    log(f"[serve] {cfg.name} {entry}: decode graph vs eager step over "
        f"{NEW - 1} steps: logits max abs diff / max abs {worst:.3e} "
        f"(limit {MODEL_TOL['rtol']:g}), greedy tokens identical ok")


def log_experts(tag, rep):
    """The expert_utilization of an MoE engine's report: its spread, the
    experts under LoadPolicy.from_report's 2% threshold, every share."""
    util = rep["expert_utilization"]
    low = [e for e, u in util.items() if u < 0.02]
    log(f"{tag} expert_utilization min {min(util.values())} max "
        f"{max(util.values())}; {len(low)} of {len(util)} under 2% "
        f"{low}; {json.dumps(util)}")


def phase_launcher(arch):
    """The Level-B launcher at the path's full-width shapes: the bench's
    loop (eager run, its report as the slimstart policy's profile, then
    lazy and slimstart runs) over one skewed workload, each engine freed
    before the next is built.  Launch counts are checked per run: every
    request and every warm-up the run built goes through the kernels."""
    import gc
    from collections import Counter

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (lazy_policy, run_service,
                                          skewed_workload)
    from repro_torch.serving import LoadPolicy, ServingEngine
    cfg = get_config(arch)
    spec = PATHS[arch]
    NEW = spec["new"]
    shapes = dict(max_new=NEW, batch_size=spec["batch"],
                  prompt_len=spec["prefill"], max_len=spec["cache"],
                  device="cuda")
    workload = skewed_workload(ServingEngine(cfg).entries(),
                               N_LAUNCHER_REQUESTS, seed=1)
    hot = workload[0]
    n_gen = sum(e != "score" for e in workload)
    log(f"[launcher] {arch}: batch {spec['batch']}, prompt "
        f"{spec['prefill']}, max_len {spec['cache']}, {NEW} new tokens; "
        f"workload {dict(Counter(workload))}, first (hot) {hot!r}")
    counters = _kernel_counters()
    policies = {"eager": LoadPolicy.eager_all(), "lazy": lazy_policy()}
    for name in ("eager", "lazy", "slimstart"):
        policy = policies[name]
        for fn in counters.values():
            fn.launches = 0
        eng, cold, lat = run_service(cfg, policy, workload, seed=1,
                                     **shapes)
        got = {n: fn.launches for n, fn in counters.items()}
        rep = eng.report()
        deferred = [c.name for c in eng.registry.values()
                    if policy.is_lazy(c)]
        built = [e for e in eng.entries()
                 if eng.registry[f"compile.{e}"].ready]
        # each built warm-up ran one prefill or forward, and a generating
        # entry's one decode step
        want = _want(cfg, len(workload) + len(built),
                     (NEW - 1) * n_gen + sum(e != "score" for e in built))
        if got != want:
            raise RuntimeError(f"launcher {name}: launches {got}, want "
                               f"{want}")
        e2e = cold + sum(sum(v) for v in lat.values())
        log(f"[launcher] {name}: cold_start_s {cold:.4f} by_group "
            f"{rep['by_group']} (at the end: {rep['total_init_s']} s in "
            f"all); {len(deferred)} deferred "
            f"{sorted(deferred, key=lambda n: (len(n), n))}")
        log(f"[launcher] {name}: first hot request ({hot}) "
            f"{lat[hot][0]:.4f} s; trace end-to-end {e2e:.4f} s; entry "
            f"latency_s mean "
            f"{ {k: round(float(np.mean(v)), 4) for k, v in lat.items()} }"
            f"; launches {got}")
        if cfg.moe is not None:
            log_experts(f"[launcher] {name}:", rep)
        if name == "eager":
            policies["slimstart"] = LoadPolicy.from_report(rep)
        del eng
        gc.collect()
        torch.cuda.empty_cache()


def phase_moe_timing(eng):
    """One moe_apply alone (layer 0's weights, CUDA events, cold L2) at
    the path's prefill (B x P tokens) and decode (B x 1) shapes, beside
    the least time this run's routing needs: the weights of the experts
    that got a kept slot, x and y once, at 3.35 TB/s; or the kept slots'
    expert products and the router at 989 TFLOP/s."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.model import _index
    cfg = eng.cfg
    spec = PATHS[cfg.name]
    B, D, E = spec["batch"], cfg.d_model, cfg.moe.n_experts
    Fe = cfg.moe.d_expert_ff
    p = _index(eng._params["layers"]["scan"]["pos0"], 0)["moe"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for S, what in ((spec["prefill"], "prefill"), (1, "decode")):
        N = B * S
        sets = [(_rand(gen, (B, S, D), cfg.tdtype),) for _ in range(4)]
        ms = time_ms(lambda x: L.moe_apply(p, cfg, x), sets)
        gs = min(cfg.moe_group, N)
        _, _, top_e, pos, cap, _ = L.moe_route(p, cfg, sets[0][0].reshape(
            N // gs, gs, D))
        kept = pos < cap
        used = int(top_e[kept].unique().numel())
        n_kept = int(kept.sum())
        es = torch.finfo(cfg.tdtype).bits // 8
        byts = used * 3 * D * Fe * es + 2 * N * D * es + D * E * es
        flops = 2 * n_kept * 3 * D * Fe + 2 * N * D * E
        bound = max(byts / PEAK_BYTES_S, flops / PEAK_FLOPS[cfg.dtype]) * 1e3
        log(f"[breakdown] {cfg.name} moe_apply {what} (B={B} S={S}, "
            f"{cfg.dtype}): {ms:.4f} ms (events, one layer); capacity "
            f"{cap}, {n_kept} of {N * cfg.moe.top_k} slots kept, {used} of "
            f"{E} experts used, {E * (N // gs) * cap} rows computed; bound "
            f"{bound:.4f} ms ({byts:.4g} B, {flops:.4g} flop)")


def phase_breakdown(eng):
    """Where one request's time goes, for information: prefill and
    decode-step wall times (host clock around synchronised calls) with
    the decode graph and with the eager step -- the graphed request's
    prefill writes into the graph's static caches, the eager one's
    builds a fresh cache tree -- and each request's wall time with one
    sync at its end; then a torch.profiler trace of one graphed and one
    eager request for the device's busy share and its kernel time by
    kind.  The request is the path's frontend entry
    (``vision_generate``, ``transcribe``) with random extras where it has
    one, else a ``generate``."""
    import torch
    spec = PATHS[eng.cfg.name]
    arch = eng.cfg.name + (f" kv_quant {eng.cfg.kv_quant}"
                           if eng.cfg.kv_quant else "")
    B, P, NEW = spec["batch"], spec["prefill"], spec["new"]
    entry = eng.entries()[-2]  # the frontend entry, else generate
    exes, params = eng.registry[f"compile.{entry}"].value, eng._params
    graph = exes["graph"]
    rng = np.random.default_rng(11)
    toks = torch.as_tensor(rng.integers(0, eng.cfg.vocab, (B, P)),
                           dtype=torch.int32, device="cuda")
    extra = eng._extras(entry, _random_extras(eng.cfg, B, rng, entry))
    pos0 = eng._pos0(entry, P)

    def request(times, graphed, sync_steps=True):
        def mark():
            if sync_steps:
                torch.cuda.synchronize()
                times.append(time.perf_counter())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        times.append(t0)
        nxt, caches, _ = exes["prefill"](
            params, toks, extra, graph.caches if graphed else None)
        mark()
        tok = nxt[:, None]
        for i in range(NEW - 1):
            if graphed:
                tok, _ = graph(tok, pos0 + i)
            else:
                pos = torch.full((B,), pos0 + i, dtype=torch.int32,
                                 device="cuda")
                tok, caches = exes["decode"](params, tok, pos, caches)
            mark()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    medians = {}
    for graphed in (True, False):
        name = "graphed" if graphed else "eager"
        request([], graphed)  # warm
        marks = []
        request(marks, graphed)
        dts = np.diff(marks)
        steps = np.sort(dts[1:])
        medians[name] = float(np.median(steps))
        wall = request([], graphed, sync_steps=False)
        log(f"[breakdown] {arch} {entry} {name}: prefill_s {dts[0]:.4f} "
            f"({'into the static caches' if graphed else 'fresh caches'})"
            f"; decode step_s median {medians[name]:.4f} min "
            f"{steps[0]:.4f} max {steps[-1]:.4f} ({len(steps)} steps); "
            f"request wall_s {wall:.4f} (one sync at its end)")
    log(f"[breakdown] {arch} decode step median eager / graphed: "
        f"{medians['eager'] / medians['graphed']:.2f}x")
    wbytes = _nbytes(params)
    bound = wbytes / PEAK_BYTES_S
    log(f"[breakdown] {arch} graphed decode step median "
        f"{medians['graphed'] * 1e3:.4f} ms against the weight-read bound "
        f"{bound * 1e3:.4f} ms (its {wbytes / 1e9:.4f} GB of parameters "
        f"read once at 3.35 TB/s): {medians['graphed'] / bound:.2f}x")
    for graphed in (True, False):
        profile_request(arch, entry, "graphed" if graphed else "eager",
                        lambda: request([], graphed, sync_steps=False))


# phase 6: the decode step with the head widened to fp32 beside the port's
HEAD_AB_ARCHS = ("granite-8b", "gemma2-9b")


def _head_widened(cfg, params, h):
    """The head with ``h`` and the weight widened to fp32, then an fp32
    GEMM: a yardstick beside the port's ``_head``, which runs one bf16
    GEMM with an fp32 result on the card."""
    import torch
    from repro_torch.models import layers as L
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.softcap(torch.matmul(h.float(), w.float()), cfg.final_softcap)


def phase_head_ab(eng):
    """For information: the graphed decode step with the port's head (the
    engine's own ``compile.generate`` graph) and with the widened one (a
    second graph captured on the same weights while ``model._head`` is
    ``_head_widened``), each over a prefill of the same prompt into its
    own static caches, 15 steps a run, timed in turns (port, widened,
    widened, port) with a sync around each step; the two graphs' logits
    and greedy tokens compared.  Launches are not the path's."""
    import functools
    import gc

    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.graphs import DecodeGraph
    cfg, B = eng.cfg, eng.B
    spec = PATHS[cfg.name]
    P, NEW = spec["prefill"], spec["new"]
    params = eng._params
    counts = {n: fn.launches for n, fn in _kernel_counters().items()}
    cache_len = eng.max_len + cfg.vision_tokens
    graphs = {"port": eng.registry["compile.generate"].value["graph"]}
    port_head = M._head
    M._head = _head_widened
    try:
        caches = M.init_cache(cfg, B, cache_len, "cuda")
        graphs["widened"] = DecodeGraph(functools.partial(
            M.decode_step, cfg), params, caches, B, "cuda")
    finally:
        M._head = port_head
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab, (B, P)), dtype=torch.int32, device="cuda")
    steps, logits = {"port": [], "widened": []}, {}
    for name in ("port", "widened", "widened", "port"):
        g = graphs[name]
        lg, _, _ = M.prefill(cfg, params, toks, cache_len=cache_len,
                             caches=g.caches)
        tok = lg.argmax(-1).to(torch.int32)[:, None]
        run = []
        for i in range(NEW - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, lg = g(tok, P + i)
            torch.cuda.synchronize()
            steps[name].append(time.perf_counter() - t0)
            run.append((tok.clone(), lg.clone()))
        logits[name] = run
    rel = max(((a[1] - b[1]).abs().max() / b[1].abs().max()).item()
              for a, b in zip(logits["port"], logits["widened"]))
    same = all(torch.equal(a[0], b[0])
               for a, b in zip(logits["port"], logits["widened"]))
    med = {n: _median(v) for n, v in steps.items()}
    log(f"[head] {cfg.name} graphed decode step median: bf16 GEMM with "
        f"fp32 result {med['port'] * 1e3:.4f} ms, widened to fp32 "
        f"{med['widened'] * 1e3:.4f} ms ({len(steps['port'])} steps "
        f"each, in turns); logits max abs diff / max abs {rel:.3e}, greedy "
        f"tokens identical {same}")
    for n, fn in _kernel_counters().items():
        fn.launches = counts[n]
    del graphs, caches, logits
    gc.collect()
    torch.cuda.empty_cache()


def profile_request(arch, entry, name, run):
    """torch.profiler over one request: the device's busy share of the
    wall time, and device time by kernel kind.  Only device activity is
    traced (no host op is read), and the device events are read from
    the raw trace: building the profiler's event tree took minutes for
    xlstm-350m's ~2.5 x 10^5 launches a request."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    n_dev = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        n_dev += 1
        us = (ev.end_ns() - ev.start_ns()) / 1e3
        low = ev.name().lower()
        kind = ("flash_attention" if "flash_fwd" in low else
                "decode_attention" if "decode_" in low else
                "rglru_scan" if "rglru_" in low else
                "matmul" if any(k in low for k in (
                    "gemm", "nvjet", "xmma", "cutlass", "gemv")) else
                "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        by_name[ev.name()] = by_name.get(ev.name(), 0.0) + us
    busy = sum(by_kind.values())
    if busy == 0:
        log(f"[breakdown] {arch} {name} device busy share: not measured "
            "(the profiler recorded no device events)")
        return
    log(f"[breakdown] {arch} profiled {name} {entry} request: wall "
        f"{wall_us / 1e3:.2f} ms, {n_dev} device events, busy "
        f"{busy / 1e3:.2f} ms (share {busy / wall_us:.4f}, "
        f"idle {1 - busy / wall_us:.4f}; profiler overhead included)")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"[breakdown]   {name} {kind}: {us / 1e3:.3f} ms "
            f"({us / busy:.4f} of device time)")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[breakdown]   {name} top kernel {us / 1e3:.3f} ms: "
            f"{kname[:90]}")


# ------------------------------------------------------------ pool phase
POOL_ARCHS = ("granite-8b", "granite-moe-1b-a400m", "whisper-large-v3",
              "pixtral-12b")


def _measured_engine_class():
    """ServingEngine that records the device memory its cold start
    added (``held``: memory after the cold start less memory before)."""
    import torch
    from repro_torch.serving import ServingEngine

    class MeasuredEngine(ServingEngine):
        def cold_start(self):
            m0 = torch.cuda.memory_allocated()
            s = super().cold_start()
            self.held = torch.cuda.memory_allocated() - m0
            return s
    return MeasuredEngine


def _pool_builders():
    from repro_torch.configs import get_config
    cls = _measured_engine_class()

    def builder(arch):
        spec = PATHS[arch]
        return lambda: cls(get_config(arch), batch_size=spec["batch"],
                           prefill_len=spec["prefill"],
                           max_len=spec["cache"], device="cuda")
    return {arch: builder(arch) for arch in POOL_ARCHS}


def _scratch_bytes():
    """Bytes of the decode kernel's per-stream scratch sets (those no
    graph owns)."""
    from repro_torch.kernels.decode_attention import _workspace
    return sum(t.numel() * t.element_size()
               for pair in _workspace.values() for t in pair)


def _drop_all(pool):
    import gc

    import torch
    for eng in list(pool.warm.values()):
        for comp in eng.registry.values():
            comp.drop()
    pool.warm.clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase_pool():
    """EnginePool over four full-width models (batch 4, the phase-5
    prompt and cache sizes), max_warm=2: a seeded sequence of two passes
    over the four models (each pass a permutation, its last model sent
    twice), so every pass misses at least twice (>= 4 evictions) and the
    second revisits evicted models.  Checked: each dispatch's path and
    the victims against a model of the pool's policy fed the engines'
    measured cold starts; stats' hits, misses and evictions; after each
    dispatch that evicted, device memory at most what the warm engines
    held at admission plus the decode scratch (so none of a victim's
    weights remain); no growth of the unexplained rest from the first
    pass to the second; exact launch counts.  Then ``rewarm()`` on the
    warm engines, and single-flight with queue_depth=2: 5 threads on one
    cold model give one build, 2 queued, 2 shed."""
    import gc
    import threading

    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import EnginePool, PoolSaturated, ServingEngine
    gc.collect()
    torch.cuda.empty_cache()
    # PyTorch keeps two 512-byte blocks of graph-safe RNG state while any
    # CUDA graph lives (allocated by the first capture, freed with the
    # last graph): a graph kept alive over the phase puts them in the base
    keeper = _keeper_graph()
    base = torch.cuda.memory_allocated()
    scratch0 = _scratch_bytes()
    rng = np.random.default_rng(5)
    perm = [POOL_ARCHS[i] for i in rng.permutation(len(POOL_ARCHS))]
    seq = (perm + perm[-1:]) * 2
    inputs = [rng.integers(0, get_config(a).vocab,
                           (PATHS[a]["batch"], PATHS[a]["prefill"]))
              for a in seq]
    log(f"[pool] max_warm 2, sequence {seq}; base memory "
        f"{base / 2**30:.3f} GiB")
    pool = EnginePool(_pool_builders(), max_warm=2)
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    sim: dict[str, int] = {}  # warm model -> dispatches, admission order
    cold_s: dict[str, float] = {}
    want_paths, want_evict, builds, revisits = [], [], [], []
    residual = []
    for i, (arch, toks) in enumerate(zip(seq, inputs)):
        new = PATHS[arch]["new"]
        gc.collect()
        out, lat, path = pool.dispatch(arch, "generate", toks,
                                       max_new_tokens=new)
        evicted = None
        if arch in sim:
            want_paths.append("warm")
        else:
            want_paths.append("cold")
            if arch in want_evict:
                revisits.append(arch)
            builds.append(arch)
            if len(sim) >= 2:
                evicted = min(sim, key=lambda m: cold_s[m] * sim[m])
                del sim[evicted]
                want_evict.append(evicted)
            sim[arch] = 0
            cold_s[arch] = pool.warm[arch].cold_start_s
        sim[arch] += 1
        if path != want_paths[-1] or pool.evictions != want_evict:
            raise RuntimeError(f"pool dispatch {i} ({arch}): path {path}, "
                               f"evictions {pool.evictions}; the policy "
                               f"gives {want_paths[-1]}, {want_evict}")
        if out.shape != (PATHS[arch]["batch"], new) or out.min() < 0 \
                or out.max() >= get_config(arch).vocab:
            raise RuntimeError(f"pool {arch}: bad tokens {out.shape}")
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - base
        held = sum(e.held for e in pool.warm.values())
        scratch = _scratch_bytes() - scratch0
        residual.append(alloc - held - scratch)
        msg = (f"[pool] {i}: {arch} {path} {lat:.4f} s; warm "
               f"{sorted(pool.warm)}; memory above base "
               f"{alloc / 2**30:.3f} GiB, held at admission "
               f"{held / 2**30:.3f} GiB (" + ", ".join(
                   f"{m} {e.held / 2**30:.3f}"
                   for m, e in pool.warm.items()) + f"), scratch "
               f"{scratch} B")
        if evicted is not None:
            from repro_torch.models.model import param_count
            gone = param_count(get_config(evicted)) * 2
            msg += (f"; evicted {evicted} ({gone / 2**30:.3f} GiB of "
                    f"weights)")
            if alloc > held + scratch:
                raise RuntimeError(f"pool: after evicting {evicted}, "
                                   f"{alloc} B above base > {held} B held "
                                   f"+ {scratch} B scratch")
        log(msg)
    got = {n: fn.launches for n, fn in counters.items()}
    want = {n: 0 for n in counters}
    for arch in POOL_ARCHS:
        cfg = get_config(arch)
        n_built = builds.count(arch)
        n_entries = len(ServingEngine(cfg, device="cuda").entries())
        for n, v in _want(cfg, n_entries * n_built + seq.count(arch),
                          (n_entries - 1) * n_built
                          + (PATHS[arch]["new"] - 1) * seq.count(arch)
                          ).items():
            want[n] += v
    st = pool.stats()
    log(f"[pool] stats hits {st['hits']} misses {st['misses']} evictions "
        f"{st['evictions']}; launches {got} (want {want}); unexplained "
        f"memory after pass 1 {residual[len(seq) // 2 - 1]} B, after pass "
        f"2 {residual[-1]} B")
    if (st["hits"], st["misses"], st["evictions"]) != (
            want_paths.count("warm"), want_paths.count("cold"), want_evict):
        raise RuntimeError(f"pool stats {st} against the sequence")
    log(f"[pool] evicted models built again: {revisits}")
    if len(want_evict) < 4 or not revisits:
        raise RuntimeError("pool: the sequence evicted fewer than 4 or "
                           "revisited no evicted model")
    if got != want:
        raise RuntimeError(f"pool launches {got}, want {want}")
    if residual[-1] > residual[len(seq) // 2 - 1]:
        raise RuntimeError("pool: memory grew from the first pass to the "
                           "second (graphs, caches or scratch leaked)")
    rewarmed = pool.rewarm()
    log(f"[pool] rewarm(): prewarm {rewarmed}")
    if set(rewarmed) != set(pool.warm) or not all(
            "weights.core" in v for v in rewarmed.values()):
        raise RuntimeError(f"pool rewarm: {rewarmed}")
    _drop_all(pool)

    # single-flight: one cold model, 5 callers, 2 may wait
    arch = "whisper-large-v3"
    n_built = []
    builders = _pool_builders()

    def counted():
        n_built.append(1)
        return builders[arch]()

    qpool = EnginePool({arch: counted}, max_warm=1, queue_depth=2)
    toks = inputs[seq.index(arch)]
    paths, sheds, outs = [], [], []

    def call():
        try:
            out, _, path = qpool.dispatch(arch, "generate", toks,
                                          max_new_tokens=4)
            paths.append(path)
            outs.append(out)
        except PoolSaturated:
            sheds.append(1)

    threads = [threading.Thread(target=call) for _ in range(5)]
    for t in threads:
        t.start()
        time.sleep(0.02)
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise RuntimeError("pool: a queued dispatch did not return")
    st = qpool.stats()
    log(f"[pool] queue_depth 2, 5 threads on cold {arch}: builds "
        f"{len(n_built)}, paths {sorted(paths)}, sheds {len(sheds)}; "
        f"stats sheds {st['sheds']} coalesced {st['coalesced']} "
        f"queue_wait_p99_s {st['queue_wait_p99_s']:.4f}")
    if len(n_built) != 1 or sorted(paths) != ["cold", "queued", "queued"] \
            or len(sheds) != 2 or st["sheds"] != 2 or st["coalesced"] != 2:
        raise RuntimeError("pool: single-flight / shed counts")
    if any(not np.array_equal(o, outs[0]) for o in outs):
        raise RuntimeError("pool: queued serves gave other tokens")
    log(f"[pool] rewarm(): prewarm {qpool.rewarm()}")
    _drop_all(qpool)
    del keeper


def _keeper_graph():
    """A one-op CUDA graph (see phase_pool)."""
    import torch
    x = torch.zeros(1, device="cuda")
    keeper = torch.cuda.CUDAGraph()
    with torch.cuda.graph(keeper):
        x.add_(1)
    return keeper, x


def phase_batcher():
    """ContinuousBatcher on full-width granite-8b: 4 slots, 640-slot
    caches, 12 requests (prompts of 64-512 tokens, 4-16 new tokens, from
    a seed), once with the decode step captured as a graph over the
    batcher's caches and once with the eager step on a cache tree of its
    own; every request's tokens must agree.  Launches counted per run:
    flash once per layer per (batch-1, ragged) prefill, decode once per
    layer per step."""
    import gc
    from functools import partial

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import ContinuousBatcher, Request
    from repro_torch.serving.graphs import DecodeGraph
    cfg = get_config("granite-8b")
    n_slots, cache_len = 4, 640
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                           "cuda")
    rng = np.random.default_rng(13)
    reqs = [(int(rng.integers(64, 513)), int(rng.integers(4, 17)))
            for _ in range(12)]
    prompts = [rng.integers(0, cfg.vocab, (L,)) for L, _ in reqs]

    def prefill_fn(tokens):
        logits, caches, _ = M.prefill(cfg, params, tokens,
                                      cache_len=cache_len)
        return logits.argmax(-1).to(torch.int32), caches

    def eager_decode(tok, pos, caches):
        logits, caches = M.decode_step(cfg, params, tok, pos, caches)
        return logits.argmax(-1).to(torch.int32)[:, None], caches

    counters = _kernel_counters()
    per = _per_call(cfg)
    results = {}
    for name in ("graphed", "eager"):
        caches = M.init_cache(cfg, n_slots, cache_len, "cuda")
        if name == "graphed":
            graph = DecodeGraph(partial(M.decode_step, cfg), params, caches,
                                n_slots, "cuda")

            def decode_fn(tok, pos, caches):
                return graph(tok, pos)[0], caches
        else:
            decode_fn = eager_decode
        batcher = ContinuousBatcher(prefill_fn, decode_fn, caches,
                                    n_slots=n_slots)
        for fn in counters.values():
            fn.launches = 0
        for rid, (p, (_, new)) in enumerate(zip(prompts, reqs)):
            batcher.submit(Request(rid=rid, tokens=p, max_new_tokens=new))
        t0 = time.perf_counter()
        st = batcher.run_until_drained()
        wall = time.perf_counter() - t0
        got = {n: fn.launches for n, fn in counters.items()}
        want = {"flash_attention": per["flash_attention"] * len(reqs),
                "decode_attention": per["decode_attention"] * st["steps"],
                "rglru_scan": 0}
        log(f"[batcher] granite-8b {name}: {st['finished']} finished in "
            f"{st['steps']} steps, {wall:.4f} s; mean_latency_s "
            f"{st['mean_latency_s']:.4f} p99_latency_s "
            f"{st['p99_latency_s']:.4f}; slow steps {st['slow_steps']}; "
            f"launches {got} (want {want})")
        if st["finished"] != len(reqs) or got != want:
            raise RuntimeError(f"batcher {name}: {st}, launches {got}")
        results[name] = {r.rid: r.out_tokens for r in batcher.finished}
        del batcher, caches, decode_fn
        if name == "graphed":
            del graph
        gc.collect()
    if any(len(results["graphed"][r]) != new
           for r, (_, new) in enumerate(reqs)):
        raise RuntimeError("batcher: a request got the wrong token count")
    if results["graphed"] != results["eager"]:
        bad = [r for r in results["eager"]
               if results["graphed"][r] != results["eager"][r]]
        raise RuntimeError(f"batcher: graphed tokens differ from eager in "
                           f"requests {bad}")
    log(f"[batcher] prompts {[L for L, _ in reqs]}, new "
        f"{[n for _, n in reqs]}: graphed tokens equal eager tokens ok")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# -------------------------------------------------------------- phase 5e
# full-width granite-8b, depth cut to 8 of its 36 layers: bf16 weights
# and grads, fp32 masters and two fp32 moments are 16 B a parameter, so
# 36 layers (8.0 B parameters) would need ~128 GB; 8 layers (1.95 B)
# need ~31 GB beside the activations of batch 4 x 4096
TRAIN = dict(arch="granite-8b", layers=8, batch=4, seq=4096, steps=6,
             lr=1e-3)


def _train_cfg():
    from repro_torch.configs import get_config
    return get_config(TRAIN["arch"]).with_(n_layers=TRAIN["layers"])


def _model_flops(cfg, B, S):
    """Model FLOPs of one train step (forward and backward, remat's
    recompute not counted): 6 x (parameters in matmuls, the tied head
    included) x tokens, plus attention's 3 x 4 x B x H x (causal pairs)
    x hd."""
    from repro_torch.models import model as M
    matmul_params = M.param_count(cfg) - cfg.n_layers * 2 * cfg.d_model \
        - cfg.d_model  # the norms' scales
    pairs = S * (S + 1) // 2
    attn = 3 * 4 * B * cfg.n_heads * pairs * cfg.head_dim * cfg.n_layers
    return 6 * matmul_params * B * S + attn


def phase_train_kernels():
    """At the training attention shape (bf16, causal, the chunk of the
    backward above attn_chunk_threshold): the flash kernel against its
    plain version, timed beside SDPA, and the plain backward's time.
    Returns the kernel entry (launches filled by phase_train)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_plain)
    cfg = _train_cfg()
    B, S = TRAIN["batch"], TRAIN["seq"]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    chunk = cfg.attn_chunk_q if S > cfg.attn_chunk_threshold else 0
    gen = torch.Generator(device="cuda").manual_seed(9)
    shape = (f"train: B={B} H={H} K={K} Sq={S} Skv={S} hd={hd} "
             f"window=None softcap=None causal")

    def model_layout():
        q5 = _rand(gen, (B, S, K, H // K, hd), torch.bfloat16)
        k4 = _rand(gen, (B, S, K, hd), torch.bfloat16)
        v4 = _rand(gen, (B, S, K, hd), torch.bfloat16)
        return (q5.reshape(B, S, H, hd).transpose(1, 2), k4.transpose(1, 2),
                v4.transpose(1, 2))
    n0 = flash_attention.launches
    args = model_layout()
    got = flash_attention(*args)
    torch.cuda.synchronize()
    err = _check("flash_attention", got, flash_attention_plain(*args),
                 "bfloat16", shape)
    del got
    one = 2 * (B * S * H * hd + 2 * B * S * K * hd)

    def make_sets():
        return [model_layout() for _ in range(n_sets(one))]
    sets = make_sets()
    ms = time_ms(lambda q, k, v: flash_attention(q, k, v), sets)
    plain_ms = time_ms(lambda q, k, v: flash_attention_plain(q, k, v), sets,
                       iters=5, warmup=1)
    lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), sets)
    q, k, v = sets[0]
    o = flash_attention(q, k, v)
    do = torch.randn_like(o)
    bwd_ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, do,
                                                 chunk=chunk), [()],
                     iters=5, warmup=1)
    flash_attention.launches = n0  # the checks' launches are not the path's
    pairs = S * (S + 1) // 2
    flops = 4 * B * H * pairs * hd
    byts = 2 * (2 * B * H * S * hd) + 2 * (2 * B * K * S * hd)
    # the backward reads q, k, v, o, dO and writes dq, dk, dv; its five
    # products over the causal pairs are 2.5x the forward's two
    bwd_bound = max(2.5 * flops / PEAK_FLOPS["bfloat16"],
                    2 * (4 * B * H * S * hd + 4 * B * K * S * hd)
                    / PEAK_BYTES_S) * 1e3
    log(f"[train] plain attention backward (flash_attention_bwd, fp32 "
        f"products, query chunk {chunk}) at {shape}: {bwd_ms:.4f} ms a "
        f"call, x {cfg.n_layers} layers = {bwd_ms * cfg.n_layers:.2f} ms a "
        f"step; bf16 bound {bwd_bound:.4f} ms")
    del sets, q, k, v, o, do, args
    torch.cuda.empty_cache()
    return _entry("flash_attention", "flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:92",
                  f"{TRAIN['arch']} train", shape, err, ms, plain_ms, lib_ms,
                  flops, byts, "bfloat16", (make_sets, lambda q, k, v:
                                            flash_attention(q, k, v),
                                            "flash_fwd")), bwd_ms


def phase_train(entry, bwd_ms):
    """Full-width granite-8b cut to TRAIN["layers"] layers, bf16, remat
    per block: TRAIN["steps"] steps of make_train_step on one repeated
    batch of the port's synthetic pipeline (launches counted per step),
    then 2 steps with accum_steps=2 and 2 with simulate_int8; fails
    unless loss and grad norm stay finite, the loss falls and flash
    launches exactly twice per layer a step.  For information: step
    time, tokens/s, peak memory, MFU and one profiled step by kind."""
    import gc

    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as M
    from repro_torch.training.adamw import adamw_init
    from repro_torch.training.compress import simulate_int8
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.step import make_train_step
    cfg = _train_cfg()
    B, S = TRAIN["batch"], TRAIN["seq"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    opt = adamw_init(params)
    torch.cuda.synchronize()
    n_params = M.param_count(cfg)
    log(f"[train] {TRAIN['arch']} full width, {cfg.n_layers} of 36 layers: "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
        f"hd {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {n_params} "
        f"params ({cfg.dtype}, fp32 masters and moments), remat "
        f"{cfg.remat}; init {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(make_pipeline(cfg.vocab, B, S, seed=0)).items()}
    per_step_flash = _train_launches(cfg)["flash_attention"]

    def run(step, n, micro=1):
        nonlocal params, opt
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            flash_attention.launches = 0
            t = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            if flash_attention.launches != per_step_flash * micro:
                raise RuntimeError(
                    f"train: {flash_attention.launches} flash launches in a "
                    f"step, want {per_step_flash * micro}")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise RuntimeError(f"train: loss {loss}, grad norm {gnorm}")
            out.append((loss, gnorm, dt))
        return out

    step = make_train_step(cfg, lr=TRAIN["lr"])
    main = run(step, TRAIN["steps"])
    losses = [x[0] for x in main]
    log(f"[train] {TRAIN['steps']} steps lr {TRAIN['lr']} on one batch "
        f"{B} x {S}: loss {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x[1], 4) for x in main]}, step_s "
        f"{[round(x[2], 4) for x in main]}; flash launches "
        f"{per_step_flash} a step ok")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train: the loss did not fall: {losses}")
    entry["launches"] = per_step_flash * TRAIN["steps"]
    acc = run(make_train_step(cfg, lr=TRAIN["lr"], accum_steps=2), 2,
              micro=2)
    comp = run(make_train_step(cfg, lr=TRAIN["lr"],
                               compress_fn=simulate_int8), 2)
    log(f"[train] accum_steps 2: loss {[round(x[0], 4) for x in acc]} "
        f"step_s {[round(x[2], 4) for x in acc]}; simulate_int8: loss "
        f"{[round(x[0], 4) for x in comp]} step_s "
        f"{[round(x[2], 4) for x in comp]}; finite ok")
    step_s = float(np.median([x[2] for x in main[1:]]))
    flops = _model_flops(cfg, B, S)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] step_s median {step_s:.4f} (steps 2-{TRAIN['steps']}), "
        f"tokens/s {B * S / step_s:.1f}, peak {peak:.3f} GiB, model "
        f"FLOPs {flops:.4g} a step, MFU {flops / step_s / PEAK_FLOPS['bfloat16']:.4f} "
        f"(dense bf16 peak 989 TFLOP/s); plain attention backward "
        f"{bwd_ms * cfg.n_layers / 1e3 / step_s:.4f} of the step (events, "
        f"phase 5e)")
    profile_train_step(step, lambda: (params, opt), batch)
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()


def profile_train_step(step, state, batch):
    """torch.profiler (CPU and CUDA) over one train step: the device's
    busy share and its time by kind, from the raw trace's device events.
    Kernels that run inside the device spans of the
    ``flash_attention_bwd`` and ``adamw_update`` ranges are the plain
    attention backward and the optimizer; the rest go by kernel name:
    flash (its forward kernel), matmul, elementwise and other."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    params, opt = state()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ranges = {"flash_attention_bwd": "attention backward (plain)",
              "adamw_update": "optimizer"}
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CUDA]
    spans = [(ev.start_ns(), ev.end_ns(), ranges[ev.name()])
             for ev in events if ev.name() in ranges]
    kernels = [ev for ev in events if ev.name() not in ranges]

    def kind_of(ev):
        for start, end, kind in spans:
            if start <= ev.start_ns() < end:
                return kind
        low = ev.name().lower()
        return ("flash" if "flash_fwd" in low else
                "matmul" if any(k in low for k in (
                    "gemm", "nvjet", "xmma", "cutlass", "gemv")) else
                "elementwise" if "elementwise" in low else "other")
    by_kind: dict[str, float] = {}
    by_name: dict[tuple, float] = {}
    for ev in kernels:
        us = (ev.end_ns() - ev.start_ns()) / 1e3
        kind = kind_of(ev)
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        by_name[kind, ev.name()] = by_name.get((kind, ev.name()), 0.0) + us
    busy = sum(by_kind.values())
    if busy == 0:
        log("[train] profiled step: not measured (the profiler recorded no "
            "device events)")
        return
    n_spans = {k: sum(s[2] == k for s in spans) for k in ranges.values()}
    log(f"[train] profiled step: wall {wall_us / 1e3:.2f} ms, "
        f"{len(kernels)} device events, busy {busy / 1e3:.2f} ms (share "
        f"{busy / wall_us:.4f}, idle {1 - busy / wall_us:.4f}; profiler "
        f"overhead included); range spans {n_spans}")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"[train]   {kind}: {us / 1e3:.3f} ms ({us / busy:.4f} of "
            f"device time)")
        top = sorted(((t, n) for (k, n), t in by_name.items() if k == kind),
                     reverse=True)[:3]
        for t, n in top:
            log(f"[train]     {t / 1e3:.3f} ms: {n[:90]}")


# -------------------------------------------------------------- phase 5f
MESH_PATH = dict(arch="granite-8b", batch=4, prefill=512, new=16)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _serve_eager(cfg, params, toks, cache_len, new, place):
    """A prefill and ``new - 1`` greedy decode steps, eager; ``place(t,
    n_extra)`` puts an input where the run needs it.  Returns (tokens
    (B, new), each step's whole logits, prefill s, decode-step s)."""
    import torch
    from repro_torch.models import model as M

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    B, P = toks.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches, _ = M.prefill(cfg, params, place(toks, 1),
                              cache_len=cache_len)
    lg = whole(lg)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    logits, steps = [lg], []
    nxt = lg.argmax(-1).to(torch.int32)
    out = [nxt]
    for i in range(new - 1):
        pos = torch.full((B,), P + i, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = M.decode_step(cfg, params, place(nxt[:, None], 1),
                                   place(pos, 0), caches)
        lg = whole(lg)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        nxt = lg.argmax(-1).to(torch.int32)
        logits.append(lg)
        out.append(nxt)
    return torch.stack(out, 1), logits, t_pre, steps


def phase_mesh():
    """The sharded serve path on the card: a one-rank NCCL process group,
    a (1, 1) ("data", "model") mesh, full-width granite-8b's parameters
    distributed by ``param_shardings``; a prefill of B 4 x 512 and 15
    decode steps, eager, under ``use_mesh`` (constraints bound, caches
    placed by ``cache_pspecs``) against the unmeshed eager path on the
    same weights: flash and decode launched on local shards (36 a
    prefill, 36 a step), identical greedy tokens, logits within 2e-3 of
    their scale; prefill and decode-step medians both ways."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import distribute_params, param_shardings
    from repro_torch.distributed.sharding import batch_pspec, distribute_tree
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models.partition import use_mesh
    spec = MESH_PATH
    cfg = get_config(spec["arch"])
    B, P, NEW = spec["batch"], spec["prefill"], spec["new"]
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_debug_mesh((1, 1), ("data", "model"))
        params = M.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0), "cuda")
        toks = torch.as_tensor(np.random.default_rng(11).integers(
            0, cfg.vocab, (B, P)), dtype=torch.int32, device="cuda")
        counters = _kernel_counters()
        with torch.no_grad():
            plain = [_serve_eager(cfg, params, toks, P + NEW, NEW,
                                  lambda t, n: t) for _ in range(2)]
            dparams = distribute_params(params, cfg, mesh)
            placements = param_shardings(cfg, mesh)

            def place(t, n):
                return distribute_tree({"t": t}, {"t": batch_pspec(
                    mesh, batch_size=B, extra_dims=n)}, mesh)["t"]
            meshed = []
            for i in range(2):
                for fn in counters.values():
                    fn.launches = 0
                with use_mesh(mesh):
                    meshed.append(_serve_eager(cfg, dparams, toks, P + NEW,
                                               NEW, place))
                got = {n: fn.launches for n, fn in counters.items()}
                want = _want(cfg, 1, NEW - 1)
                log(f"[mesh] run {i}: launches {got} (want {want})")
                if got != want:
                    raise RuntimeError("mesh: the sharded path did not run "
                                       "through the kernels as expected")
        tok_p, log_p, _, _ = plain[-1]
        tok_m, log_m, _, _ = meshed[-1]
        rel = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(log_m, log_p))
        same = torch.equal(tok_m, tok_p)
        pl = sorted({str(tuple(str(p) for p in v))
                     for _, v in _leaves(placements)})
        log(f"[mesh] {spec['arch']} full width ({cfg.n_layers} layers, "
            f"{M.param_count(cfg)} params, {cfg.dtype}) on a (1, 1) "
            f"('data', 'model') NCCL mesh, parameter placements {pl}; "
            f"batch {B}, prompt {P}, {NEW - 1} decode steps; greedy tokens "
            f"identical to the unmeshed path: {same}; logits max abs diff "
            f"/ max abs {rel:.3e}")
        if not same or not rel <= MODEL_TOL["rtol"]:
            raise RuntimeError(f"mesh: the sharded path differs from the "
                               f"unmeshed one (tokens same {same}, rel "
                               f"{rel:.3e})")
        for name, runs in (("unmeshed", plain), ("meshed", meshed)):
            pre = [r[2] for r in runs]
            steps = [x for r in runs for x in r[3]]
            log(f"[mesh] {name} eager: prefill s {[round(x, 4) for x in pre]}"
                f", decode step median {_median(steps):.4f} s "
                f"(min {min(steps):.4f}, {len(steps)} steps)")
        del params, dparams, plain, meshed
    finally:
        dist.destroy_process_group()
    import gc
    gc.collect()
    torch.cuda.empty_cache()


# -------------------------------------------------------------- phase 5g
# granite-8b's three cells on the production mesh, and one two-pod cell
DRYRUN_CELLS = (("granite-8b", "train_4k", False),
                ("granite-8b", "prefill_32k", False),
                ("granite-8b", "decode_32k", False),
                ("granite-8b", "decode_32k", True))


def phase_dryrun():
    """``launch/dryrun.py``'s ``run_cell`` on the meta device (a fake
    process group of 256 or 512 ranks, this process rank 0): per-device
    argument and temp bytes against the card's 80 GB, FLOPs, bytes and
    collective bytes by kind; fails where a cell whose "model" axis
    shards a parameter shows no collective."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import param_pspecs
    from repro_torch.launch.dryrun import COLLECTIVES, run_cell
    from repro_torch.launch.mesh import HW
    for arch, shape, mp in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = run_cell(arch, shape, multi_pod=mp, save=False)
        wall = time.perf_counter() - t0
        mem, cost, coll = r["memory"], r["cost"], r["collectives"]
        sizes = dict(zip(r["mesh_axes"], r["mesh"]))
        log(f"[dryrun] {arch} {shape} mesh {r['mesh']} {r['mesh_axes']} "
            f"act_mode {r['act_mode']} accum {r['accum_steps']}: wall "
            f"{wall:.1f} s; per device argument "
            f"{mem['argument_bytes'] / 1e9:.3f} GB, output "
            f"{mem['output_bytes'] / 1e9:.3f} GB, temp "
            f"{mem['temp_bytes'] / 1e9:.3f} GB (of {HW['hbm_bytes'] / 1e9:.0f}"
            f" GB); flops {cost['flops']:.4e}, bytes "
            f"{cost['bytes_accessed']:.4e}; collective bytes "
            + ", ".join(f"{k} {coll[k]}" for k in COLLECTIVES)
            + f" (total {coll['total']}, calls {coll['calls']})")
        specs = param_pspecs(get_config(arch),
                             types.SimpleNamespace(shape=sizes))
        shards = any(a == "model" or (isinstance(a, tuple) and "model" in a)
                     for _, spec in _leaves(specs) for a in spec)
        if shards and not coll["total"]:
            raise RuntimeError(f"dryrun {arch} {shape}: the model axis "
                               "shards parameters but no collective ran")


class _Phase:
    """Logs a phase's wall time when it ends."""

    def __init__(self, what):
        self.what = what

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        log(f"[time] {self.what}: {time.perf_counter() - self.t0:.1f} s")


def main():
    import gc

    import torch
    t_start = time.perf_counter()
    with _Phase("1 device"):
        smi = phase_device()
    from repro_torch.configs import get_config
    with _Phase("2 build"):
        phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with _Phase("3 kernels"):
        kernels = {
            "granite-8b": [
                flash_cases(gen, "granite-8b", [
                    (1, 4, 1, 40, 40, 32, True, 16, None, "MQA+window"),
                    (1, 2, 2, 33, 33, 16, True, None, 30.0,
                     "softcap+ragged"),
                    (1, 4, 2, 100, 100, 64, True, None, None, "ragged GQA"),
                    (1, 2, 2, 16, 80, 16, False, None, None,
                     "bidir Sq!=Skv"),
                    (1, 4, 2, 130, 130, 128, True, None, None,
                     "hd 128 S 130"),
                    (1, 4, 2, 200, 200, 128, True, None, None,
                     "hd 128 S 200"),
                    (1, 4, 2, 16, 200, 128, False, None, None,
                     "hd 128 bidir Sq 16 Skv 200")]),
                decode_cases(gen, "granite-8b", "partly filled", [
                    (2, 2, 1, 40, 16, 16, None, "ring+window"),
                    (1, 2, 2, 33, 16, None, 30.0, "softcap"),
                    (1, 1, 4, 48, 16, None, None, "MQA ragged"),
                    (1, 2, 4, 20, 128, None, None,
                     "hd 128 S 20 (one split)"),
                    (1, 1, 16, 200, 128, None, None, "hd 128 G 16 S 200"),
                    (2, 2, 1, 150, 64, 40, 30.0,
                     "hd 64 G 1 ring+window+softcap")])],
            # qwen2.5-32b: hd 128, G 5 (odd: five query heads of a kv
            # head, padded to 16 MMA rows in decode_mma)
            "qwen2.5-32b": [
                flash_cases(gen, "qwen2.5-32b", [
                    (1, 10, 2, 130, 130, 128, True, None, None,
                     "hd 128 G 5 S 130"),
                    (1, 10, 2, 16, 200, 128, False, None, None,
                     "hd 128 G 5 bidir Sq 16 Skv 200")]),
                decode_cases(gen, "qwen2.5-32b", "partly filled", [
                    (2, 2, 5, 77, 128, None, None, "hd 128 G 5 ragged"),
                    (1, 2, 5, 20, 128, None, None,
                     "hd 128 G 5 S 20 (one split)")])],
            "granite-moe-1b-a400m": [
                flash_cases(gen, "granite-moe-1b-a400m", [
                    (1, 4, 2, 130, 130, 64, True, None, None,
                     "hd 64 G 2 S 130"),
                    (1, 4, 2, 16, 200, 64, False, None, None,
                     "hd 64 bidir Sq 16 Skv 200")]),
                decode_cases(gen, "granite-moe-1b-a400m", "partly filled", [
                    (2, 2, 2, 77, 64, None, None, "hd 64 G 2 ragged")])],
            # olmoe-1b-7b: hd 128, G 1 (15 of decode_mma's 16 rows pad)
            "olmoe-1b-7b": [
                flash_cases(gen, "olmoe-1b-7b", [
                    (1, 4, 4, 130, 130, 128, True, None, None,
                     "hd 128 G 1 S 130"),
                    (2, 4, 4, 24, 24, 128, True, None, None,
                     "hd 128 G 1 S 24")]),
                decode_cases(gen, "olmoe-1b-7b", "partly filled", [
                    (2, 4, 1, 33, 128, None, None, "hd 128 G 1 ragged"),
                    (2, 3, 1, 77, 128, None, None, "hd 128 G 1 S 77")])],
            "recurrentgemma-2b": [
                flash_cases(gen, "recurrentgemma-2b", [
                    (1, 10, 1, 100, 100, 256, True, 48, None,
                     "hd 256 G 10 ragged+window"),
                    (1, 2, 1, 130, 130, 256, True, None, None,
                     "hd 256 S 130"),
                    (1, 2, 1, 200, 200, 256, True, None, None,
                     "hd 256 S 200"),
                    (1, 10, 1, 200, 200, 256, True, 48, None,
                     "hd 256 G 10 S 200 window 48"),
                    (1, 2, 1, 130, 130, 256, True, None, 50.0,
                     "hd 256 softcap 50"),
                    (1, 2, 1, 16, 200, 256, False, None, None,
                     "hd 256 bidir Sq 16 Skv 200")]),
                decode_cases(gen, "recurrentgemma-2b", "wrapped ring", [
                    (2, 1, 10, 96, 256, 96, None,
                     "hd 256 G 10 ring+window"),
                    (1, 1, 10, 33, 256, None, None, "hd 256 G 10 ragged")]),
                rglru_cases(gen, "recurrentgemma-2b")],
            "pixtral-12b": [
                flash_cases(gen, "pixtral-12b", [
                    (1, 8, 2, 300, 300, 128, True, None, None,
                     "hd 128 G 4 S 300")], what="vision prefill"),
                decode_cases(gen, "pixtral-12b", "partly filled", [
                    (2, 2, 4, 110, 128, None, None, "hd 128 G 4 ragged")])],
            "whisper-large-v3": [
                flash_cases(gen, "whisper-large-v3", [
                    (1, 4, 4, 150, 150, 64, False, None, None,
                     "hd 64 G 1 no mask S 150"),
                    (2, 4, 4, 1, 70, 64, False, None, None,
                     "hd 64 G 1 Sq 1 Skv 70")],
                    sq=get_config("whisper-large-v3").encoder_seq,
                    causal=False, what="encoder"),
                flash_cases(gen, "whisper-large-v3", [
                    (2, 4, 4, 100, 100, 64, True, None, None,
                     "hd 64 G 1 S 100")], what="decoder self"),
                flash_cases(gen, "whisper-large-v3", [
                    (2, 4, 4, 100, 300, 64, False, None, None,
                     "hd 64 G 1 Sq 100 Skv 300")],
                    sq=PATHS["whisper-large-v3"]["prefill"],
                    skv=get_config("whisper-large-v3").encoder_seq,
                    causal=False, what="cross attention"),
                decode_cases(gen, "whisper-large-v3", "partly filled", [
                    (2, 3, 1, 70, 64, None, None, "hd 64 G 1 ragged")]),
                decode_cases(gen, "whisper-large-v3", "all valid", [],
                             all_valid=[
                                 (2, 3, 1, 77, 64, "hd 64 G 1 all S 77"),
                                 (1, 2, 1, 33, 64, "hd 64 G 1 all S 33")],
                             slots=get_config(
                                 "whisper-large-v3").encoder_seq)],
            # gemma2: hd 256, G 2, softcap 50 on every layer, a 4096-key
            # window on the local ones; gemma3: hd 128, G 2, a 1024-key
            # window on the local ones, no softcap
            "gemma2-9b": [
                flash_cases(gen, "gemma2-9b", [
                    (1, 4, 2, 200, 200, 256, True, 48, 50.0,
                     "hd 256 G 2 S 200 window 48 softcap 50"),
                    (2, 4, 2, 130, 130, 256, True, None, 50.0,
                     "hd 256 G 2 S 130 softcap 50")], what="local prefill"),
                flash_cases(gen, "gemma2-9b", [], what="global prefill",
                            local=False),
                decode_cases(gen, "gemma2-9b", "wrapped ring", [
                    (2, 2, 2, 150, 256, 64, 50.0,
                     "hd 256 G 2 ring+window+softcap"),
                    (1, 2, 2, 200, 256, None, 50.0,
                     "hd 256 G 2 softcap ragged")]),
                decode_cases(gen, "gemma2-9b", "partly filled", [],
                             local=False)],
            "gemma3-27b": [
                flash_cases(gen, "gemma3-27b", [
                    (1, 4, 2, 300, 300, 128, True, 64, None,
                     "hd 128 G 2 S 300 window 64")], what="local prefill"),
                flash_cases(gen, "gemma3-27b", [], what="global prefill",
                            local=False),
                decode_cases(gen, "gemma3-27b", "wrapped ring", [
                    (2, 2, 2, 150, 128, 64, None, "hd 128 G 2 ring+window")]),
                decode_cases(gen, "gemma3-27b", "partly filled", [],
                             local=False)],
            "xlstm-350m": [],  # no kernel: mLSTM / sLSTM in plain PyTorch
        }
    with _Phase("4 parity"):
        phase_parity("granite-8b", 5)
        phase_parity("qwen2.5-32b", 5)
        phase_parity("recurrentgemma-2b", 20)  # past the reduced window
        phase_parity("granite-moe-1b-a400m", 5)
        phase_parity("olmoe-1b-7b", 5)
        phase_parity("pixtral-12b", 5)
        phase_parity("whisper-large-v3", 5)
        # past the reduced windows of 16
        phase_parity("gemma2-9b", 20)
        phase_parity("gemma3-27b", 20)
        phase_parity("xlstm-350m", 5)
        phase_parity("gemma2-9b", 20, kv_quant="int8")
    with _Phase("4b grad parity"):
        for arch in ("granite-8b", "recurrentgemma-2b",
                     "granite-moe-1b-a400m", "whisper-large-v3",
                     "gemma2-9b"):
            phase_grad_parity(arch)
        phase_flash_grad()
    with _Phase("4c mesh on this torch"):
        phase_mesh_torch()
    for arch, entries in kernels.items():
        with _Phase(f"5 serve + 6 breakdown {arch}"):
            eng = phase_serve(arch, entries)
            phase_breakdown(eng)
            if eng.cfg.moe is not None:
                phase_moe_timing(eng)
            if PATHS[arch].get("kv_quant"):
                phase_kv_quant(eng)
            if arch in HEAD_AB_ARCHS:
                phase_head_ab(eng)
            del eng  # free this path's weights before the next path's
            gc.collect()
            torch.cuda.empty_cache()
    for arch in LAUNCHER_ARCHS:
        with _Phase(f"5b launcher {arch}"):
            phase_launcher(arch)
    with _Phase("5c pool"):
        phase_pool()
    with _Phase("5d batcher"):
        phase_batcher()
    with _Phase("5e train"):
        train_entry, bwd_ms = phase_train_kernels()
        phase_train(train_entry, bwd_ms)
        kernels["granite-8b train"] = [train_entry]
    with _Phase("5f mesh"):
        phase_mesh()
    with _Phase("5g dryrun"):
        phase_dryrun()
    with _Phase("7 device_ms"):
        phase_device_time([e for es in kernels.values() for e in es])
    log(f"[time] total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [e for es in kernels.values()
                                  for e in es]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
