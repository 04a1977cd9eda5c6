#!/usr/bin/env python3
"""Drive the port's distribution layer (``src/repro_torch``) on four CUDA
cards over NCCL.

    python3 mesh_smoke.py [--phases a,b,c1,c2,c3,d]

Four ranks, one per card, started with ``torch.multiprocessing``; each
joins one NCCL process group and builds two meshes on it: ("data",
"model") = (2, 2) for training and (1, 4) for tensor-parallel serving.
With fewer than four cards it prints why and exits 1 (it never shrinks
the mesh and never falls back to gloo or the CPU).  An exception in any
rank fails the run.  Phases (each logs its wall time):

A. device and NCCL -- every card's name and power limit (nvidia-smi),
   the NCCL version; ``all_reduce``, ``all_gather_into_tensor`` and
   ``reduce_scatter_tensor`` on bf16 at 1 MiB, 64 MiB and 1 GiB over the
   world and over each dim group of the (2, 2) mesh: time (the slowest
   rank's, CUDA events) and bus bandwidth (nccl-tests' convention);
B. int8 all-reduce -- ``training.compress.int8_allreduce`` against a
   plain ``all_reduce`` in bf16 and in fp32, on granite-8b's gradient
   leaves at their local shard sizes under (2, 2), over the "data" group
   and over the world: time, payload bytes (from the dtypes sent) and the
   error against the fp32 mean, which must stay within one quantization
   step of the shared scale;
C. training on (2, 2), the state built in place by
   ``distributed.init_sharded_state`` (parameters by ``param_pspecs``,
   fp32 masters and moments by ``opt_pspecs``: ZeRO-1), steps of
   ``training.step.make_train_step`` under ``use_mesh`` in "sp" mode:
   1. reduced fp32 granite-8b, 3 steps against one unmeshed rank on the
      same weights and batches: loss, grad norm and every parameter and
      master leaf within 2e-4 of the leaf's scale;
   2. granite-8b cut to 8 layers, bf16, B 4 x 4096 (chip_smoke.py's
      phase 5e): the meshed step 1 against the unmeshed step on card 0
      (freed before the meshed run), loss within 1e-2 relative;
   3. full-depth granite-8b (36 layers), B 4 x 4096, 10 steps at lr
      3e-4 on the synthetic pipeline's batches: step time, tokens/s, MFU
      against 4 x 989 TFLOP/s, per-card peak memory, flash launches, the
      NCCL kernels' share of device time and the collective bytes by
      kind of the tenth step (torch.profiler's communication events, and
      the dry-run's ``StepCounter`` on the real step); then one
      reduce-scatter over "model" of a row-parallel output's (2, 4096,
      4096) elements in fp32 against bf16;
   4. those bytes against ``launch.dryrun.run_cell`` of the same step on
      the meta device (run in the parent while the ranks work): the
      profiler's all-gather, all-reduce, reduce-scatter and all-to-all
      bytes each within 5% of the dry-run's, else the run fails;
D. tensor-parallel serving, qwen2.5-32b on (1, 4) (10 query and 2 kv
   heads a rank, the 152064-row head row-sharded), parameters built in
   place (``init_sharded_state(optimizer=False)``), eager, the decode
   steps through ``make_serve_steps``:
   1. B 4 x prompt 512, 15 decode steps against the unmeshed path on
      card 0 (run first, freed before): first greedy token of every row
      identical; launches per rank exactly 64 flash a prefill and 64
      decode a step.  Then each of the 64 layers is held on its own
      (``repro_torch.distributed.parity``): the unmeshed prefill's input
      to layer l, kept on card 0 and broadcast, goes through the meshed
      layer l, whose output must be within ``parity.LAYER_RTOL`` (max
      abs diff / max abs) and ``parity.LAYER_MISMATCH`` (share of bf16
      elements not identical) of the unmeshed layer's; the same for the
      final norm + head.  The same pass with bf16 partial sums
      (``parity.bf16_partial_sums``) must fail those limits at every
      layer (the head, column-parallel, has no partial sum to round).
      Reported beside them, no limit: the per-layer gaps of the
      row-parallel products summed as four K-slices on card 0, in fp32
      (the yardstick of the limits) and in bf16, the end-to-end
      last-token logit gap and ``rounding_gaps``.  A failed D1 check is
      recorded and D2 runs all the same (on the same weights); the run
      then exits 1 without its last line;
   2. B 4 x prompt 32768 ("sp" prefill), cache 32784, 16 new tokens,
      twice: prefill s, decode-step median, per-card peak, the NCCL
      share of device time (second run, profiled), logits finite, the
      same tokens both runs; then the flash kernel alone at a rank's
      shape (B 4, H 10, K 2, S 32768, hd 128, causal) against its plain
      version, its bound and SDPA.

``--phases`` runs a subset (C4 comes with c3).  Ends with ``{"ok": true, "device": {"platform":
"gpu", "kind": ..., "count": 4}}``.  ``build/mesh_smoke/results.json``
holds every reading.  A rank prints nothing unless it is rank 0 or
fails.
"""

from __future__ import annotations

import datetime
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))
OUT = REPO / "build" / "mesh_smoke"

WORLD = 4
DEV = "cuda"  # every tensor of the run lives on the rank's card
# H100 SXM peaks (NVIDIA data sheet, dense), for MFU and bound_ms
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_S = 3.35e12
COLL_SIZES = (1 << 20, 64 << 20, 1 << 30)
GRAD_RTOL = 2e-4   # of each leaf's largest magnitude
LOGIT_RTOL = 3e-2  # bf16, of the outputs' scale (the flash row)
# C4: the profiler's bytes of C3's step within 5% of the dry-run's
C4_RTOL = 0.05
C4_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
C1 = dict(arch="granite-8b", batch=4, seq=64, steps=3, lr=3e-4)
C2 = dict(arch="granite-8b", layers=8, batch=4, seq=4096, lr=1e-3)
# accum_steps 1: the dry-run of this step on (2, 2) counts 32.2 GB of
# arguments and 16.7 GB of temporaries a card
C3 = dict(arch="granite-8b", batch=4, seq=4096, steps=10, lr=3e-4, accum=1)
D1 = dict(arch="qwen2.5-32b", batch=4, prefill=512, new=16)
D2 = dict(arch="qwen2.5-32b", batch=4, prefill=32768, cache=32784, new=16)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# ------------------------------------------------------------ rank helpers
class Rank:
    """One rank's state: its meshes, where it writes, what it found."""

    def __init__(self, rank, out_dir):
        from repro_torch.launch.mesh import make_debug_mesh
        self.rank = rank
        self.out = Path(out_dir)
        self.mesh22 = make_debug_mesh((2, 2), ("data", "model"), DEV)
        self.mesh14 = make_debug_mesh((1, 4), ("data", "model"), DEV)
        self.results: dict = {}

    def log(self, *a):
        if self.rank == 0:
            print(*a, flush=True)

    def save(self):
        if self.rank == 0:
            (self.out / "results.json").write_text(
                json.dumps(self.results, indent=1))


def _barrier():
    import torch
    import torch.distributed as dist
    dist.barrier(device_ids=[torch.cuda.current_device()])


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _num(t) -> float:
    return float(_whole(t))


def _max_over_ranks(x: float, group=None) -> float:
    import torch
    import torch.distributed as dist
    t = torch.tensor([x], dtype=torch.float64, device=DEV)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t)


def _gather(x) -> list:
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def _event_ms(fn, iters, warmup=1):
    """Mean ms of ``fn()`` over ``iters`` calls, CUDA events, after a
    barrier (collectives start together)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    _barrier()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _cuda_gen(seed):
    import torch
    return torch.Generator(device=DEV).manual_seed(seed)


def _place(mesh, B):
    """put(t, n_extra): ``t`` as a DTensor batch-sharded on its first
    dim."""
    from repro_torch.distributed.sharding import batch_pspec, distribute_tree

    def put(t, n):
        return distribute_tree({"t": t}, {"t": batch_pspec(
            mesh, batch_size=B, extra_dims=n)}, mesh)["t"]
    return put


def _device_kernels(prof):
    """(name, microseconds) of every device kernel the profiler saw."""
    from torch.autograd import DeviceType
    return [(ev.name(), ev.duration_ns() / 1e3)
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA]


def _nccl_share(kernels):
    total = sum(us for _, us in kernels)
    nccl = sum(us for name, us in kernels if "nccl" in name.lower())
    return (nccl / total if total else None), total / 1e3, len(kernels)


# ------------------------------------------------------------- phase A
def phase_a(r: Rank):
    import torch
    import torch.distributed as dist
    groups = (("world", None), ("data", r.mesh22.get_group("data")),
              ("model", r.mesh22.get_group("model")))
    rows = []
    for gname, group in groups:
        n = dist.get_world_size(group)
        for size in COLL_SIZES:
            numel = size // 2
            whole = torch.zeros(numel, dtype=torch.bfloat16, device=DEV)
            part = torch.zeros(numel // n, dtype=torch.bfloat16,
                               device=DEV)
            ops = (("all_reduce", 2 * (n - 1) / n,
                    lambda: dist.all_reduce(whole, group=group)),
                   ("all_gather_into_tensor", (n - 1) / n,
                    lambda: dist.all_gather_into_tensor(whole, part,
                                                        group=group)),
                   ("reduce_scatter_tensor", (n - 1) / n,
                    lambda: dist.reduce_scatter_tensor(part, whole,
                                                       group=group)))
            for op, factor, fn in ops:
                ms = _max_over_ranks(_event_ms(
                    fn, iters=5 if size >= 1 << 30 else 20, warmup=2))
                algbw = size / (ms / 1e3) / 1e9
                rows.append(dict(group=gname, ranks=n, op=op, bytes=size,
                                 ms=ms, algbw_GBs=algbw,
                                 busbw_GBs=algbw * factor))
                r.log(f"[A] {op} {gname} ({n} ranks) bf16 "
                      f"{size / 2**20:.0f} MiB: {ms:.4f} ms (slowest rank), "
                      f"algbw {algbw:.1f} GB/s, busbw "
                      f"{algbw * factor:.1f} GB/s")
            del whole, part
    r.results["A"] = rows
    _free()


# ------------------------------------------------------------- phase B
def _local_shapes(cfg, mesh):
    """{leaf path: local shard shape} of ``cfg``'s parameters on
    ``mesh``."""
    from repro_torch.distributed.sharding import _local_index, param_pspecs
    from repro_torch.models.model import _leaves, model_template
    from repro_torch.models.partition import to_placements
    specs = dict(_leaves(param_pspecs(cfg, mesh)))
    return {path: tuple(n for _, n in _local_index(
        s.shape, to_placements(specs[path], mesh), mesh))
        for path, s in _leaves(model_template(cfg))}


def phase_b(r: Rank):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.training.compress import int8_allreduce
    cfg = get_config("granite-8b")
    shapes = _local_shapes(cfg, r.mesh22)
    gen = _cuda_gen(100 + r.rank)
    out = []
    for gname, group in (("data", r.mesh22.get_group("data")),
                         ("world", None)):
        n = dist.get_world_size(group)
        tot = dict(int8_ms=0.0, bf16_ms=0.0, fp32_ms=0.0, int8_bytes=0,
                   bf16_bytes=0, fp32_bytes=0, numel=0)
        worst = 0.0
        for path, shape in shapes.items():
            g = (torch.randn(shape, generator=gen, device=DEV)
                 * 1e-3).to(torch.bfloat16)
            numel = g.numel()
            mean = g.float()
            dist.all_reduce(mean, group=group)
            mean /= n
            scale = g.float().abs().max() / 127.0
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
            got = int8_allreduce({"g": g}, group=group)["g"]
            err = float((got.float() - mean).abs().max())
            step = float(scale)
            del got, mean
            if not err <= step:
                raise RuntimeError(f"B: int8_allreduce {path} over {gname}: "
                                   f"error {err:.3e} beyond one step "
                                   f"{step:.3e} of the shared scale")
            worst = max(worst, err / step)
            t8 = _event_ms(lambda: int8_allreduce({"g": g}, group=group),
                           iters=3)
            x16 = g.clone()

            def plain(x):
                dist.all_reduce(x, group=group)
                x.div_(n)
            t16 = _event_ms(lambda: plain(x16), iters=3)
            del x16
            x32 = g.float()
            t32 = _event_ms(lambda: plain(x32), iters=3)
            del x32, g
            _free()
            t8, t16, t32 = (_max_over_ranks(t) for t in (t8, t16, t32))
            row = dict(group=gname, leaf=path, shape=list(shape),
                       int8_ms=t8, bf16_ms=t16, fp32_ms=t32,
                       int8_bytes=numel * 4 + 4, bf16_bytes=numel * 2,
                       fp32_bytes=numel * 4, err=err, step=step)
            out.append(row)
            for k in tot:
                tot[k] += row[k] if k != "numel" else numel
            r.log(f"[B] {gname} ({n} ranks) {path} {list(shape)}: int8 "
                  f"{t8:.4f} ms ({numel * 4 + 4} B int32 codes + fp32 "
                  f"scale), bf16 {t16:.4f} ms ({numel * 2} B), fp32 "
                  f"{t32:.4f} ms ({numel * 4} B); int8 error "
                  f"{err:.3e} = {err / step:.3f} of a step")
        r.log(f"[B] {gname} ({n} ranks) all {len(shapes)} leaves "
              f"({tot['numel']} elements a rank): int8 "
              f"{tot['int8_ms']:.3f} ms / {tot['int8_bytes']} B, bf16 "
              f"{tot['bf16_ms']:.3f} ms / {tot['bf16_bytes']} B, fp32 "
              f"{tot['fp32_ms']:.3f} ms / {tot['fp32_bytes']} B; int8 "
              f"over fp32 time {tot['int8_ms'] / tot['fp32_ms']:.3f}, over "
              f"bf16 {tot['int8_ms'] / tot['bf16_ms']:.3f}; worst error "
              f"{worst:.3f} of a step")
        out.append(dict(group=gname, leaf="all", **tot, worst_step=worst))
    r.results["B"] = out


# ------------------------------------------------------------- phase C
def _pipeline_batch(cfg, B, S, it=None, seed=0):
    """The synthetic pipeline's next batch, on the card."""
    import torch
    from repro_torch.training.data import make_pipeline
    it = it or make_pipeline(cfg.vocab, B, S, seed=seed)
    return {k: torch.as_tensor(v, device=DEV)
            for k, v in next(it).items()}, it


def phase_c1(r: Rank):
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.distributed import init_sharded_state
    from repro_torch.models import model as M
    from repro_torch.models.partition import use_act_mode, use_mesh
    from repro_torch.training.adamw import adamw_init
    from repro_torch.training.step import make_train_step
    from repro_torch.training.tree import tree_leaves
    cfg = get_reduced(C1["arch"]).with_(dtype="float32")
    B, S = C1["batch"], C1["seq"]
    step = make_train_step(cfg, lr=C1["lr"])
    rng = np.random.default_rng(20)
    batches = []
    for _ in range(C1["steps"]):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + 1)),
                              dtype=torch.int32, device=DEV)
        batches.append({"tokens": tok[:, :-1].contiguous(),
                        "labels": tok[:, 1:].contiguous()})
    want = []
    if r.rank == 0:
        params = M.init_params(cfg, _cuda_gen(0), DEV)
        opt = adamw_init(params)
        for b in batches:
            params, opt, m = step(params, opt, b)
            want.append((_num(m["loss"]), _num(m["grad_norm"])))
        want_leaves = [t.cpu() for t in tree_leaves((params, opt.master))]
        del params, opt
    _barrier()
    dparams, dopt = init_sharded_state(cfg, r.mesh22, _cuda_gen(0), DEV)
    put = _place(r.mesh22, B)
    got = []
    for b in batches:
        with use_mesh(r.mesh22), use_act_mode("sp"):
            dparams, dopt, m = step(dparams, dopt,
                                    {k: put(v, 1) for k, v in b.items()})
        got.append((_num(m["loss"]), _num(m["grad_norm"])))
    got_leaves = [_whole(t).cpu() for t in tree_leaves((dparams,
                                                        dopt.master))]
    del dparams, dopt
    if r.rank == 0:
        worst = max(float((g - w).abs().max() / w.abs().max())
                    for g, w in zip(got_leaves, want_leaves))
        rel = max(abs(g - w) / abs(w) for gs, ws in zip(got, want)
                  for g, w in zip(gs, ws))
        r.log(f"[C1] reduced fp32 {C1['arch']} B {B} x S {S}, "
              f"{C1['steps']} steps lr {C1['lr']}, (2, 2) ZeRO-1 'sp' "
              f"against one unmeshed rank: (loss, grad_norm) meshed "
              f"{[tuple(round(x, 6) for x in g) for g in got]} unmeshed "
              f"{[tuple(round(x, 6) for x in w) for w in want]} (worst "
              f"rel {rel:.3e}); {len(got_leaves)} parameter and master "
              f"leaves: worst max abs diff / max abs {worst:.3e} (limit "
              f"{GRAD_RTOL})")
        r.results["C1"] = dict(got=got, want=want, worst_leaf=worst,
                               worst_metric=rel)
        if not (worst <= GRAD_RTOL and rel <= GRAD_RTOL):
            raise RuntimeError("C1: the ZeRO-1 steps differ from the "
                               "unmeshed ones")
    _free()


def _train_step_timed(step, params, opt, batch):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    loss, gnorm = _num(m["loss"]), _num(m["grad_norm"])
    torch.cuda.synchronize()
    return params, opt, loss, gnorm, time.perf_counter() - t0


def phase_c2(r: Rank):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import init_sharded_state
    from repro_torch.models import model as M
    from repro_torch.models.partition import use_act_mode, use_mesh
    from repro_torch.training.adamw import adamw_init
    from repro_torch.training.step import make_train_step
    cfg = get_config(C2["arch"]).with_(n_layers=C2["layers"])
    B, S = C2["batch"], C2["seq"]
    batch, _ = _pipeline_batch(cfg, B, S)
    step = make_train_step(cfg, lr=C2["lr"])
    if r.rank == 0:
        params = M.init_params(cfg, _cuda_gen(0), DEV)
        opt = adamw_init(params)
        w_loss, w_gn, w_s = _train_step_timed(step, params, opt,
                                              batch)[2:]
        del params, opt
        _free()
    _barrier()
    torch.cuda.reset_peak_memory_stats()
    dparams, dopt = init_sharded_state(cfg, r.mesh22, _cuda_gen(0), DEV)
    put = _place(r.mesh22, B)
    with use_mesh(r.mesh22), use_act_mode("sp"):
        loss, gn, dt = _train_step_timed(
            step, dparams, dopt, {k: put(v, 1) for k, v in batch.items()})[2:]
    peaks = _gather(torch.cuda.max_memory_allocated() / 2**30)
    del dparams, dopt
    _free()
    if r.rank == 0:
        rel = abs(loss - w_loss) / abs(w_loss)
        r.log(f"[C2] {C2['arch']} {cfg.n_layers} layers bf16 B {B} x S "
              f"{S} lr {C2['lr']}: step 1 (2, 2) ZeRO-1 'sp' loss "
              f"{loss:.6f} grad_norm {gn:.6f} ({dt:.4f} s, first call) "
              f"against the unmeshed step on card 0 loss {w_loss:.6f} "
              f"grad_norm {w_gn:.6f} ({w_s:.4f} s, first call): loss rel "
              f"{rel:.3e} (limit 1e-2); meshed peak GiB a card "
              f"{[round(p, 3) for p in peaks]}")
        r.results["C2"] = dict(loss=loss, grad_norm=gn, step_s=dt,
                               want_loss=w_loss, want_grad_norm=w_gn,
                               want_step_s=w_s, rel=rel, peak_gib=peaks)
        if not rel <= 1e-2:
            raise RuntimeError(f"C2: meshed loss {loss} against {w_loss}")


def _model_flops(cfg, B, S):
    """chip_smoke.py's model FLOPs of one train step: 6 x (parameters in
    matmuls, the tied head included) x tokens, plus attention's 3 x 4 x
    B x H x (causal pairs) x hd."""
    from repro_torch.models import model as M
    matmul_params = M.param_count(cfg) - cfg.n_layers * 2 * cfg.d_model \
        - cfg.d_model
    pairs = S * (S + 1) // 2
    attn = 3 * 4 * B * cfg.n_heads * pairs * cfg.head_dim * cfg.n_layers
    return 6 * matmul_params * B * S + attn


DT_BYTES = {"Float": 4, "BFloat16": 2, "Half": 2, "Int": 4, "Long": 8,
            "Char": 1, "Byte": 1, "Bool": 1, "Double": 8}
COMM_KINDS = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
              ("allgather", "all-gather"), ("all_gather", "all-gather"),
              ("reduce_scatter", "reduce-scatter"),
              ("reducescatter", "reduce-scatter"),
              ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
              ("broadcast", "broadcast"))


def comm_bytes(trace_path):
    """Result bytes and calls by kind of the collectives in a chrome
    trace: events whose args name a collective ("Collective name", "Out
    msg nelems", "dtype"), the host-side records where there are any,
    else the device kernels'."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    tagged = [ev for ev in events
              if "Collective name" in (ev.get("args") or {})]
    host = [ev for ev in tagged if ev.get("cat") != "kernel"]
    use = host or tagged
    by_kind: dict = {}
    calls: dict = {}
    for ev in use:
        a = ev["args"]
        name = str(a["Collective name"]).lower()
        kind = next((k for frag, k in COMM_KINDS if frag in name), name)
        n = int(a.get("Out msg nelems", 0) or 0)
        by_kind[kind] = by_kind.get(kind, 0) + n * DT_BYTES.get(
            str(a.get("dtype")), 0)
        calls[kind] = calls.get(kind, 0) + 1
    return by_kind, calls, ("host" if host else "device" if tagged
                            else "none")


def phase_c3(r: Rank):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.distributed import init_sharded_state
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.models.partition import use_act_mode, use_mesh
    from repro_torch.training.step import make_train_step
    cfg = get_config(C3["arch"])
    B, S, accum = C3["batch"], C3["seq"], C3["accum"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = init_sharded_state(cfg, r.mesh22, _cuda_gen(0), DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    state_gib = torch.cuda.memory_allocated() / 2**30
    r.log(f"[C3] {C3['arch']} full depth ({cfg.n_layers} layers) on (2, 2):"
          f" state built in place in {t_init:.2f} s, {state_gib:.3f} GiB "
          f"allocated on rank 0")
    step = make_train_step(cfg, lr=C3["lr"], accum_steps=accum)
    put = _place(r.mesh22, B)
    it = None
    rows = []
    per_step_flash = 2 * cfg.n_layers * accum  # forward and remat recompute
    counter = None
    for i in range(C3["steps"]):
        batch, it = _pipeline_batch(cfg, B, S, it)
        batch = {k: put(v, 1) for k, v in batch.items()}
        flash_attention.launches = 0
        profiled = i == C3["steps"] - 1
        with use_mesh(r.mesh22), use_act_mode("sp"):
            if profiled and r.rank == 0:
                counter = StepCounter()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    with counter:
                        params, opt, loss, gn, dt = _train_step_timed(
                            step, params, opt, batch)
            else:
                params, opt, loss, gn, dt = _train_step_timed(
                    step, params, opt, batch)
        if flash_attention.launches != per_step_flash:
            raise RuntimeError(f"C3: {flash_attention.launches} flash "
                               f"launches in a step, want {per_step_flash}")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise RuntimeError(f"C3: step {i + 1} loss {loss} grad_norm {gn}")
        rows.append((loss, gn, dt))
        r.log(f"[C3] step {i + 1}: loss {loss:.6f} grad_norm {gn:.6f} "
              f"{dt:.4f} s{' (profiled)' if profiled else ''}")
    peaks = _gather(torch.cuda.max_memory_allocated() / 2**30)
    del params, opt, batch
    _free()
    rs_ms = _rs_f32_bf16(r, B // 2 * S * cfg.d_model)
    if r.rank != 0:
        return
    times = [x[2] for x in rows[1:-1]]  # steps 2-9: not the profiled one
    step_s = float(np.median(times))
    flops = _model_flops(cfg, B, S)
    mfu = flops / step_s / (WORLD * PEAK_FLOPS_BF16)
    share, busy_ms, n_k = _nccl_share(_device_kernels(prof))
    trace = r.out / "c3_trace.json"
    prof.export_chrome_trace(str(trace))
    measured, calls, source = comm_bytes(trace)
    trace.unlink()
    r.log(f"[C3] step_s median {step_s:.4f} (steps 2-{C3['steps'] - 1}), "
          f"tokens/s {B * S / step_s:.1f}, model FLOPs {flops:.4g} a step, "
          f"MFU {mfu:.4f} (4 x 989 TFLOP/s), accum_steps {accum}, flash "
          f"launches {per_step_flash} a step ok; peak GiB a card "
          f"{[round(p, 3) for p in peaks]}; losses "
          f"{[round(x[0], 4) for x in rows]}")
    r.log(f"[C3] profiled step {C3['steps']}: {n_k} device kernels, "
          f"{busy_ms:.2f} ms "
          f"busy, NCCL share of device time {share}; collectives from the "
          f"profiler's communication events ({source}): bytes {measured} "
          f"calls {calls}; from StepCounter on the real step: bytes "
          f"{counter.collectives} calls {counter.collective_calls}")
    r.log(f"[C3] one row-parallel output's reduce-scatter over 'model' "
          f"(slowest rank, CUDA events), ({B // 2}, {S}, {cfg.d_model}) "
          f"elements: fp32 {rs_ms['float32']:.4f} ms "
          f"({B // 2 * S * cfg.d_model * 4} B in), bf16 "
          f"{rs_ms['bfloat16']:.4f} ms ({B // 2 * S * cfg.d_model * 2} B "
          f"in); fp32 - bf16 {rs_ms['float32'] - rs_ms['bfloat16']:.4f} ms")
    r.results["C3"] = dict(
        rs_ms=rs_ms,
        rows=rows, step_s=step_s, tokens_s=B * S / step_s, mfu=mfu,
        flops=flops, peak_gib=peaks, init_s=t_init, accum=accum,
        nccl_share=share, busy_ms=busy_ms,
        profiler_bytes=measured, profiler_calls=calls,
        profiler_source=source, counter_bytes=counter.collectives,
        counter_calls=counter.collective_calls)


def _rs_f32_bf16(r, numel) -> dict:
    """Mean ms of one ``reduce_scatter_tensor`` of ``numel`` elements over
    the (2, 2) mesh's "model" group in fp32 and in bf16 (the slowest
    rank's)."""
    import torch
    import torch.distributed as dist
    group = r.mesh22.get_group("model")
    n = dist.get_world_size(group)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        whole = torch.zeros(numel, dtype=dt, device=DEV)
        part = torch.zeros(numel // n, dtype=dt, device=DEV)
        out[str(dt).split(".")[1]] = _max_over_ranks(_event_ms(
            lambda: dist.reduce_scatter_tensor(part, whole, group=group),
            iters=10, warmup=2))
        del whole, part
    _free()
    return out


def dryrun_c3():
    """The meta-device dry-run of phase C3's step on a fake (2, 2)
    world (in the parent process)."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import ShapeSpec
    t0 = time.perf_counter()
    r = run_cell(C3["arch"], "train_4k", shape=ShapeSpec(
        "train_4k", C3["seq"], C3["batch"], "train"), mesh_shape=(2, 2),
        accum_steps=C3["accum"], act_mode="sp", save=False)
    r["wall_s"] = time.perf_counter() - t0
    return r


# ------------------------------------------------------------- phase D
def _kernel_counters():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention}


def _serve(cfg, params, toks, cache_len, new, put, mode="dp"):
    """A prefill (``M.prefill``, logits constrained as ``make_serve_steps``'
    prefill does) in act mode ``mode`` and ``new - 1`` greedy decode
    steps of ``make_serve_steps``' decode_fn, eager.  Returns (tokens (B,
    new), last-token prefill logits (fp32), prefill s, decode-step s,
    whether every step's logits were finite)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.partition import constrain, use_act_mode
    from repro_torch.training.step import make_serve_steps
    _, decode_fn = make_serve_steps(cfg, cache_len=cache_len)
    B, P = toks.shape
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_act_mode(mode):
            lg, caches, _ = M.prefill(cfg, params, put(toks, 1),
                                      cache_len=cache_len)
            lg = _whole(constrain(lg, "batch", None)).float()
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
    finite = bool(torch.isfinite(lg).all())
    first = lg
    nxt = lg.argmax(-1).to(torch.int32)
    out, steps = [nxt], []
    for i in range(new - 1):
        pos = torch.full((B,), P + i, dtype=torch.int32, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lg, caches = decode_fn(params, put(nxt[:, None], 1), put(pos, 0),
                                  caches)
        lg = _whole(lg)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(lg).all())
        nxt = lg.argmax(-1).to(torch.int32)
        out.append(nxt)
    del caches
    return torch.stack(out, 1), first, t_pre, steps, finite


def _check_launches(r, counters, want, what):
    got = {n: fn.launches for n, fn in counters.items()}
    bad = _gather(got != want)
    r.log(f"[D] {what}: launches on rank 0 {got} (want {want} on every "
          f"rank)")
    if any(bad):
        raise RuntimeError(f"D: {what}: launches {got}, want {want}")


def d1_unmeshed(cfg, toks, mesh):
    """D1's unmeshed readings on this card (rank 0's, no collective):
    the served tokens and last-token logits (``_serve``), how far
    roundings alone move those logits end to end (``rounding_gaps``),
    the prefill's residual stream layer by layer
    (``parity.unmeshed_stream``) and, per layer from that stream, the gap
    of the row-parallel products summed as K-slices over ``mesh``'s
    "model" ranks (``parity.k_slice_dot``), in fp32 (the yardstick of
    the per-layer limits) and in bf16 (the fault's arithmetic).  The
    parameters are freed on return."""
    import torch
    from repro_torch.distributed import parity as PA
    from repro_torch.models import model as M
    B, P, NEW = toks.shape[0], toks.shape[1], D1["new"]
    t0 = time.perf_counter()
    params = M.init_params(cfg, _cuda_gen(0), DEV)
    want = _serve(cfg, params, toks, P + NEW, NEW, lambda t, n: t)
    print(f"[D1] unmeshed {D1['arch']} on card 0 "
          f"({time.perf_counter() - t0:.1f} s with its init): prefill "
          f"{want[2]:.4f} s, decode step median {np.median(want[3]):.4f} s",
          flush=True)
    gaps = rounding_gaps(cfg, params, toks, P + NEW, want[1], mesh)
    print(f"[D1] unmeshed on card 0, last-token prefill logits moved by "
          f"roundings alone (max abs diff / max abs; reported, no limit): "
          f"row-parallel products summed as {gaps['slices']} fp32 K-slices "
          f"{gaps['k_slices']:.3e}; one input element moved by 2**-7 "
          f"{gaps['one_element']:.3e}", flush=True)
    xs, head = PA.unmeshed_stream(cfg, params, toks)
    wants = dict(enumerate(xs[1:]), head=head)
    n = gaps["slices"]
    kslice = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        kslice[name] = {l: PA.gap(y, wants[l]) for l, y in
                        PA.unmeshed_outputs(cfg, params, xs, PA.k_slice_dot(
                            cfg, params, mesh, dt))}
        _log_layers(f"[D1] card 0, row-parallel products as {n} K-slices "
                    f"summed in {name}" + (" (the fault's arithmetic)"
                                           if dt == torch.bfloat16 else ""),
                    kslice[name])
    del params
    _free()
    return want, gaps, xs, wants, kslice


def _worst(gaps: dict) -> dict:
    """The largest rel and mismatch over a ``{layer: gap}`` dict's
    layers (not the head), and where."""
    layers = {k: g for k, g in gaps.items() if k != "head"}
    rel = max(layers, key=lambda k: layers[k]["rel"])
    mis = max(layers, key=lambda k: layers[k]["mismatch"])
    return dict(rel=layers[rel]["rel"], rel_layer=rel,
                mismatch=layers[mis]["mismatch"], mismatch_layer=mis)


def _log_layers(what, gaps):
    from repro_torch.distributed import parity as PA
    w = _worst(gaps)
    bad = [k for k, g in gaps.items() if not PA.within(g)]
    print(f"{what}: {len(gaps) - 1} layers, worst rel {w['rel']:.3e} (layer "
          f"{w['rel_layer']}), worst bf16 mismatch {w['mismatch']:.4e} "
          f"(layer {w['mismatch_layer']}); head rel {gaps['head']['rel']:.3e}"
          f" mismatch {gaps['head']['mismatch']:.4e}; limits rel "
          f"{PA.LAYER_RTOL} mismatch {PA.LAYER_MISMATCH}: "
          f"{len(bad)} outside {bad[:8]}", flush=True)
    pairs = [(round(g["rel"], 6), round(g["mismatch"], 6))
             for g in gaps.values()]
    print(f"{what}: per layer (rel, mismatch) {pairs}", flush=True)
    return bad


def _layer_parity(r, cfg, params, xs, wants, put):
    """Each meshed layer of ``params`` on (1, 4) from the unmeshed
    stream ``xs`` (on rank 0, broadcast to the others a layer at a time),
    against ``wants``; rank 0 returns {layer: gap}."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import parity as PA
    B, P = D1["batch"], D1["prefill"]

    def x_at(l):
        x = xs[l] if r.rank == 0 else torch.empty(
            (B, P, cfg.d_model), dtype=cfg.tdtype, device=DEV)
        dist.broadcast(x, src=0)
        return x
    out = {}
    for l, got in PA.meshed_outputs(cfg, params, r.mesh14, x_at,
                                    lambda x: put(x, 2)):
        if r.rank == 0:
            out[l] = PA.gap(got, wants[l])
        del got
    return out


def phase_d(r: Rank):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.distributed import init_sharded_state
    from repro_torch.distributed import parity as PA
    from repro_torch.models.partition import use_mesh
    cfg = get_config(D1["arch"])
    B, P, NEW = D1["batch"], D1["prefill"], D1["new"]
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab, (B, P)), dtype=torch.int32, device=DEV)
    n_layers = cfg.n_layers
    xs = wants = None
    if r.rank == 0:
        want, gaps, xs, wants, kslice = d1_unmeshed(cfg, toks, r.mesh14)
    _barrier()
    t0 = time.perf_counter()
    params, _ = init_sharded_state(cfg, r.mesh14, _cuda_gen(0), DEV,
                                   optimizer=False)
    torch.cuda.synchronize()
    r.log(f"[D1] {D1['arch']} parameters built in place on (1, 4) in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on rank 0")
    counters = _kernel_counters()
    put = _place(r.mesh14, B)
    for fn in counters.values():
        fn.launches = 0
    with use_mesh(r.mesh14):
        got = _serve(cfg, params, toks, P + NEW, NEW, put)
    _check_launches(r, counters, {"flash_attention": n_layers,
                                  "decode_attention": n_layers * (NEW - 1)},
                    "D1 (1, 4) prefill and 15 decode steps")
    t0 = time.perf_counter()
    layers = _layer_parity(r, cfg, params, xs, wants, put)
    t_par = time.perf_counter() - t0
    with PA.bf16_partial_sums():
        fault = _layer_parity(r, cfg, params, xs, wants, put)
    del xs, wants
    if r.rank == 0:
        rel = float((got[1] - want[1]).abs().max() / want[1].abs().max())
        first_same = bool(torch.equal(got[0][:, 0], want[0][:, 0]))
        agree = float((got[0] == want[0]).float().mean())
        r.log(f"[D1] (1, 4) tensor-parallel against unmeshed, B {B} x "
              f"{P}, {NEW - 1} decode steps: first greedy token of every "
              f"row identical {first_same}; last-token prefill logits max "
              f"abs diff / max abs {rel:.3e} (reported, no limit: roundings "
              f"alone move them {gaps['k_slices']:.3e}); tokens agree "
              f"{agree:.4f} over all {NEW} steps; meshed prefill "
              f"{got[2]:.4f} s, decode step median "
              f"{np.median(got[3]):.4f} s (min {min(got[3]):.4f}) against "
              f"unmeshed {want[2]:.4f} / {np.median(want[3]):.4f} s")
        bad = _log_layers(f"[D1] (1, 4) per layer from the unmeshed "
                          f"stream ({t_par:.1f} s)", layers)
        caught = _log_layers("[D1] the same with bf16 partial sums "
                             "(the fault; must fail at every layer)", fault)
        missed = sorted(set(fault) - {"head"} - set(caught))
        r.results["D1"] = dict(
            rel=rel, first_same=first_same, agree=agree, prefill_s=got[2],
            step_s=got[3], want_prefill_s=want[2], want_step_s=want[3],
            rounding_gaps=gaps, layers=layers, worst=_worst(layers),
            kslice=kslice, kslice_worst={k: _worst(v) for k, v in
                                         kslice.items()}, fault=fault,
            fault_worst=_worst(fault), limits=dict(
                rel=PA.LAYER_RTOL, mismatch=PA.LAYER_MISMATCH))
        failed = []
        if not first_same:
            failed.append("first tokens differ")
        if bad:
            failed.append(f"layers {bad} outside the per-layer limits")
        if missed:
            failed.append(f"the per-layer check passes bf16 partial sums "
                          f"at layers {missed}")
        if failed:
            # recorded, not raised: D2 needs nothing of D1's result
            msg = "D1: " + "; ".join(failed)
            r.log(f"[D1] FAILED: {msg}")
            r.results.setdefault("failed", []).append(msg)
    # D2: the 32k prefill on the same weights
    B2, P2, C2_, NEW2 = D2["batch"], D2["prefill"], D2["cache"], D2["new"]
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab, (B2, P2)), dtype=torch.int32, device=DEV)
    put = _place(r.mesh14, B2)
    _free()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(2):
        for fn in counters.values():
            fn.launches = 0
        with use_mesh(r.mesh14):
            if i == 0:
                runs.append(_serve(cfg, params, toks, C2_, NEW2, put, "sp"))
            else:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    runs.append(_serve(cfg, params, toks, C2_, NEW2, put,
                                       "sp"))
        _check_launches(r, counters,
                        {"flash_attention": n_layers,
                         "decode_attention": n_layers * (NEW2 - 1)},
                        f"D2 run {i + 1}")
        _free()
    peaks = _gather(torch.cuda.max_memory_allocated() / 2**30)
    share, busy_ms, n_k = _nccl_share(_device_kernels(prof))
    share = _gather(share)
    same = _gather(bool(torch.equal(runs[0][0], runs[1][0])))
    finite = _gather(runs[0][4] and runs[1][4])
    del params
    _free()
    (t1, _, pre1, st1, _), (t2, _, pre2, st2, _) = runs
    r.log(f"[D2] {D2['arch']} (1, 4) B {B2} x prompt {P2} ('sp' prefill), "
          f"cache {C2_}, {NEW2} new tokens: prefill s {pre1:.4f} / "
          f"{pre2:.4f} (run 2 profiled), decode step median "
          f"{np.median(st1):.4f} s (min {min(st1):.4f}); peak GiB a card "
          f"{[round(p, 3) for p in peaks]}; NCCL share of device time "
          f"(run 2, a rank each) {share}, rank 0 busy {busy_ms:.1f} ms over "
          f"{n_k} kernels; logits finite {finite}; tokens identical in "
          f"the second run {same}")
    r.results["D2"] = dict(prefill_s=[pre1, pre2], step_s=st1,
                           step_s_run2=st2, peak_gib=peaks, nccl_share=share,
                           busy_ms=busy_ms, same=same, finite=finite)
    if not (all(same) and all(finite)):
        raise RuntimeError(f"D2: tokens identical {same}, finite {finite}")
    if r.rank == 0:
        r.results["flash"] = flash_row(cfg, B2, P2)
    _barrier()


def rounding_gaps(cfg, params, toks, cache_len, want, mesh) -> dict:
    """How far the unmeshed last-token prefill logits ``want`` (of
    ``toks``, on this card) move when only roundings change: (a) each
    row-parallel product summed as fp32 K-slices over ``mesh``'s "model"
    ranks (``parity.k_slice_dot``), the (1, 4) path's arithmetic on one
    card; (b) the plain path with one element of the first matmul's
    input (row 0's last token) moved by 2**-7 relative, two bf16 steps.
    Max abs diff over max abs of ``want``."""
    import torch
    from repro_torch.distributed import parity as PA
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    plain = L.dot
    nudged = [False]

    def one_element(x, w):
        if not nudged[0]:
            nudged[0] = True
            x = x.clone()
            x[0, -1, 7] = (x[0, -1, 7].float() * (1 + 2 ** -7)).to(x.dtype)
        return plain(x, w)

    out = {"slices": PA.mesh_sizes(mesh)["model"]}
    for name, dot in (("k_slices", PA.k_slice_dot(cfg, params, mesh)),
                      ("one_element", one_element)):
        with PA.dot_as(dot), torch.no_grad():
            lg = M.prefill(cfg, params, toks, cache_len=cache_len)[0]
        out[name] = float((lg.float() - want).abs().max()
                          / want.abs().max())
        del lg
    return out


def flash_row(cfg, B, S):
    """The flash kernel at a (1, 4) rank's shape of the 32k prefill,
    against its plain version (query chunks of 1024), its bound and SDPA;
    CUDA events."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    H, K, hd = cfg.n_heads // WORLD, cfg.n_kv_heads // WORLD, cfg.head_dim
    gen = _cuda_gen(9)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEV,
                           dtype=torch.bfloat16)
    q = rand(B, S, K, H // K, hd).reshape(B, S, H, hd).transpose(1, 2)
    k = rand(B, S, K, hd).transpose(1, 2)
    v = rand(B, S, K, hd).transpose(1, 2)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v, chunk=1024)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    del got, want

    def events(fn, iters):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters
    ms = events(lambda: flash_attention(q, k, v), 5)
    # a profiler session after an earlier one (D2's) may record none of
    # the kernels: up to three sessions
    us = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                flash_attention(q, k, v)
            torch.cuda.synchronize()
        us = [t for name, t in _device_kernels(prof)
              if "flash" in name.lower()]
        if us:
            break
    device_ms = float(np.median(us)) / 1e3 if us else None
    plain_ms = events(lambda: flash_attention_plain(q, k, v, chunk=1024), 1)
    lib_ms = events(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 5)
    flash_attention.launches = n0
    pairs = S * (S + 1) // 2
    flops = 4 * B * H * pairs * hd
    byts = 2 * (2 * B * H * S * hd) + 2 * (2 * B * K * S * hd)
    bound = max(flops / PEAK_FLOPS_BF16, byts / PEAK_BYTES_S) * 1e3
    by = "operations" if flops / PEAK_FLOPS_BF16 > byts / PEAK_BYTES_S \
        else "bytes"
    shape = (f"B={B} H={H} K={K} Sq={S} Skv={S} hd={hd} causal bf16 "
             f"(qwen2.5-32b prefill, a (1, 4) rank's heads)")
    print(f"[flash] {shape}: {ms:.4f} ms (device "
          f"{'not measured' if device_ms is None else f'{device_ms:.4f}'} "
          f"ms, profiler) against bound {bound:.4f} ms "
          f"({by}), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; max abs "
          f"err against the plain version {err:.3e} (outputs to "
          f"{scale:.3e}, limit 3e-2 relative)", flush=True)
    if not err <= LOGIT_RTOL * scale:
        raise RuntimeError(f"flash at {shape}: error {err}")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:92",
                shape=shape, max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)


# ------------------------------------------------------------ the ranks
PHASES = {"a": phase_a, "b": phase_b, "c1": phase_c1, "c2": phase_c2,
          "c3": phase_c3, "d": phase_d}


def _rank(rank, world, port, out_dir, phases):
    # segments that grow keep the allocator's fragmentation out of the
    # way of C3's and D's large transients
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, device_id=torch.device("cuda", rank),
        timeout=datetime.timedelta(seconds=300))
    try:
        r = Rank(rank, out_dir)
        for fn in (PHASES[p] for p in phases):
            t0 = time.perf_counter()
            fn(r)
            _barrier()
            r.log(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
            r.save()
    except BaseException:
        # the other ranks may wait in a collective this rank never joins,
        # and tearing the group down would wait with them: exit at once,
        # so that the parent sees the failure and ends them
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run, of "
                    f"{','.join(PHASES)} (C4 comes with c3; default: all)")
    phases = ap.parse_args(argv).phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"--phases {phases}: some of {list(PHASES)}")
    import torch
    if not torch.cuda.is_available():
        print(f"mesh_smoke: no CUDA device; this needs {WORLD} cards",
              flush=True)
        sys.exit(1)
    n = torch.cuda.device_count()
    if n < WORLD:
        print(f"mesh_smoke: {n} CUDA card(s) visible; this script needs "
              f"{WORLD} (one NCCL rank each)", flush=True)
        sys.exit(1)
    try:
        from repro_torch.kernels._build import build_all
    except ImportError as e:
        print(f"mesh_smoke: the port is not beside this script "
              f"(src/repro_torch): {e}", flush=True)
        sys.exit(1)
    import torch.multiprocessing as tmp
    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"[A] torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}, {n} cards, "
          f"phases {phases}", flush=True)
    t0 = time.perf_counter()
    build_all()
    print(f"[time] build: {time.perf_counter() - t0:.1f} s", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as out:
        ctx = tmp.start_processes(
            _rank, args=(WORLD, _free_port(), out, phases),
            nprocs=WORLD, join=False, start_method="spawn")
        dry = dryrun_c3() if "c3" in phases else None
        while not ctx.join():
            pass
        results = json.loads((Path(out) / "results.json").read_text())
    if dry is not None:
        results["C4"] = compare_c4(results["C3"], dry)
        if results["C4"]["failed"]:
            results.setdefault("failed", []).append(
                f"C4: {results['C4']['failed']} beyond {C4_RTOL} of the "
                f"dry-run's bytes")
    (OUT / "results.json").write_text(json.dumps(results, indent=1))
    print(f"[time] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    if results.get("failed"):
        print(f"mesh_smoke: FAILED: {'; '.join(results['failed'])}",
              flush=True)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def compare_c4(c3, dry):
    """Measured collective bytes of C3's profiled step by kind, over the
    dry-run's; ``failed`` lists the kinds (of ``C4_KINDS``) whose
    profiler bytes are more than ``C4_RTOL`` from the dry-run's."""
    coll = dry["collectives"]
    rows, failed = {}, []
    for kind in sorted(set(coll) - {"total", "calls"}
                       | set(c3["profiler_bytes"])):
        want = coll.get(kind, 0)
        got = c3["profiler_bytes"].get(kind, 0)
        counted = c3["counter_bytes"].get(kind, 0)
        ok = abs(got - want) <= C4_RTOL * want if want else got == 0
        if kind in C4_KINDS and not ok:
            failed.append(kind)
        rows[kind] = dict(dryrun=want, profiler=got, counter=counted,
                          ratio=(got / want if want else None),
                          dryrun_calls=coll["calls"].get(kind, 0),
                          profiler_calls=c3["profiler_calls"].get(kind, 0),
                          ok=ok)
        print(f"[C4] {kind}: profiler {got} B in "
              f"{c3['profiler_calls'].get(kind, 0)} calls, StepCounter on "
              f"the real step {counted} B, dry-run {want} B in "
              f"{coll['calls'].get(kind, 0)} calls: profiler / dry-run "
              f"{got / want if want else None} (limit 1 +- {C4_RTOL}"
              f"{'' if kind in C4_KINDS else ', not checked'}): "
              f"{'ok' if ok else 'FAILED'}", flush=True)
    print(f"[C4] dry-run of C3's step on a fake (2, 2) world: wall "
          f"{dry['wall_s']:.1f} s, per device argument "
          f"{dry['memory']['argument_bytes'] / 1e9:.3f} GB, temp "
          f"{dry['memory']['temp_bytes'] / 1e9:.3f} GB, flops "
          f"{dry['cost']['flops']:.4e}", flush=True)
    return dict(rows=rows, memory=dry["memory"], flops=dry["cost"]["flops"],
                failed=failed)


if __name__ == "__main__":
    main()
