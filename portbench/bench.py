"""One run of one cell: set up, measure, check, print one JSON line.

Everything particular to a configuration, a traffic mix or a metric is
a file found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration's numbers (each that
  names a field of the program's config checked against it) and its
  source;
- ``reference/<stem>.py``, where the configuration file names it by
  ``"reference": "<stem>"``: the configuration's plain reference,
  ``draw(cfg, seed, device)`` and ``logits(...)``, and optionally its
  own work counts (``body_params``, ``attn_flops``, ``flash_call``,
  ``decode_call``); without the key, ``reference/weights.py`` and
  ``reference/model.py`` and the shared ``metrics/counts.py``;
- ``traffic/<mix>.json``: the mix's parameters, and the generator it
  names, ``traffic/gen_<generator>.py`` (``schedule(mix, seconds)``);
- ``metrics/<metric>.py``, or ``metrics/<part before the first dot>.py``:
  the metric's reader, ``read(run) -> number or None`` (None: nothing
  to read, and the metric is left out of the line);
- ``limits/<cell>.json``: the limits of the numbers ``check`` compares.

So a later change adds a configuration, a mix or a metric by adding
files and entries only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

from portbench import reference

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names
GRACE_S = 60.0  # how long past the window's close a due invocation may take
TRACE_S = 10.0  # the traced end of a --trace 1 window (reading it is slow)
CPU_SOURCES = ("program_counter",)  # what a CPU dry run may report


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(root: Path, metric: str) -> Path:
    own = root / "portbench" / "metrics" / f"{metric}.py"
    return own if own.exists() else \
        root / "portbench" / "metrics" / f"{metric.split('.')[0]}.py"


class Cell:
    """A workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"portbench: no workload {name!r} in "
                             f"{root / 'BENCHMARK.json'}")
        w = found[0]
        self.name, self.chips = name, w["chips"]
        conf = next(c for c in bench["configs"] if c["name"] == w["config"])
        pb = root / "portbench"
        self.cfg = load_json(root / conf["file"])
        if "reference" in self.cfg:  # this root's own module, checked
            self.cfg[reference.FILE_KEY] = str(
                pb / "reference" / f"{self.cfg['reference']}.py")
            reference.module(self.cfg)
        self.mix = load_json(pb / "traffic" / f"{w['traffic']}.json")
        self.generator = load_module(
            pb / "traffic" / f"gen_{self.mix['generator']}.py")
        self.limits = load_json(pb / "limits" / f"{name}.json")

        def mine(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
        self.readers = {m["name"]: load_module(reader_path(root, m["name"]))
                        for m in self.end_to_end + self.per_layer}


class Run:
    """What the readers read: the window's records and the set-up."""

    def __init__(self, cell: Cell, cfg: dict, mix: dict, device: str):
        self.cell, self.cfg, self.mix, self.device = cell, cfg, mix, device
        self.batch = mix["batch"]
        self.closed = False
        self.setup_s = 0.0
        self.window_s = 0.0
        self.records: list[dict] = []
        self.outputs: dict = {}
        self.last_logits: dict = {}
        self.colds: list[dict] = []
        self.peak_window_bytes = None
        self.setup_peak_bytes = None
        self.trace = None
        self.notes: list[str] = []

    def note(self, msg: str) -> None:
        self.notes.append(msg)

    def traced(self) -> list:
        """The records of the invocations the trace covers."""
        return [r for r in self.records if r.get("traced")]


def tiny(mix: dict) -> dict:
    """The mix at the sizes of a CPU dry run on a reduced configuration
    (an open loop at a rate the tiny model keeps up with, so a short run
    serves a few invocations)."""
    out = dict(mix, prompt={"median": 16, "sigma": 0.6, "min": 8,
                            "max": 32, "round_to": 8},
               new_tokens=min(mix["new_tokens"], 4), prefill_len=16,
               max_len=40, check_tokens=16,
               profile_invocations=min(mix.get("profile_invocations", 0), 4))
    if "rate_per_s" in mix:
        out["rate_per_s"] = max(mix["rate_per_s"], 4.0)
    return out


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own nvcc builds go to ``build/kernels`` already)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / sub)


def _compiled(system, name) -> set:
    eng = system.pool.warm.get(name)
    if eng is None:
        return set()
    return {c.name for c in eng.registry.values()
            if c.group == "compile" and c.ready}


def drive(system, run: Run, seconds: float, tracing: bool) -> None:
    """The measured window: dispatch the mix's invocations one at a time
    in arrival order, each when it is due (open loop) or as soon as the
    last returned (closed loop).  With ``tracing`` the profiler records
    the window's last ``TRACE_S`` seconds and what runs past its close;
    the invocations it covers are marked ``traced``, and its events are
    read after the window."""
    import torch
    from portbench.system import WINDOW
    from portbench.trace import Trace
    invs = run.cell.generator.schedule(run.mix, seconds)
    run.closed = not isinstance(invs, list)
    toks = {} if run.closed else {
        inv["i"]: system.tokens(WINDOW, inv["i"], inv["prompt_len"])
        for inv in invs}
    rf = torch.profiler.record_function
    trace, window = None, rf("pb.window")
    if tracing:
        Trace(run.device == "cuda").prime()
    t0 = time.perf_counter()
    end = t0
    for inv in invs:
        now = time.perf_counter()
        if tracing and trace is None and now - t0 >= seconds - TRACE_S:
            trace = Trace(run.device == "cuda")
            trace.start()
            window.__enter__()
        if run.closed:
            if now - t0 >= seconds:
                break
            due = now
        else:
            due = t0 + inv["due_s"]
            if now < due:
                with rf("pb.wait"):
                    time.sleep(due - now)
        rec = dict(inv, path=None, ok=False, built=[],
                   traced=trace is not None)
        name = system.names[inv["function"]]
        if time.perf_counter() > t0 + seconds + GRACE_S:
            rec["latency_s"] = time.perf_counter() - due
            run.records.append(rec)  # never served: failed
            continue
        x = toks.pop(inv["i"], None)
        if x is None:
            x = system.tokens(WINDOW, inv["i"], inv["prompt_len"])
        before = _compiled(system, name)
        try:
            with rf("pb.dispatch"):
                out, path, cold, tail = system.dispatch(inv, x)
            rec.update(path=path, ok=True)
            run.outputs[inv["i"]] = out
            if tail is not None:
                run.last_logits[inv["i"]] = tail
            if cold is not None:
                run.colds.append(cold)
        except Exception:  # a failed invocation counts as missing
            log(traceback.format_exc())
        end = time.perf_counter()
        rec["built"] = sorted(_compiled(system, name) - before)
        rec["latency_s"] = end - due
        run.records.append(rec)
    run.window_s = (end - t0) if run.closed else max(seconds, end - t0)
    if trace is not None:
        window.__exit__(None, None, None)
        trace.stop()
        run.trace = trace


def evaluate(run: Run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        reader = run.cell.readers[m["name"]]
        if run.device != "cuda" and reader.SOURCE not in CPU_SOURCES:
            continue  # no time or device number from a CPU run
        v = reader.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a dry run on the configuration's reduced "
                         "sizes, for the tests only")
    return ap.parse_args(argv)


def setup(args, t_start, root: Path = ROOT):
    """(cell, run, system) with the system set up and warm, or None
    where the card the cell needs is not there."""
    cell = Cell(args.workload, root)
    import torch
    cuda = args.device == "cuda"
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cuda and found < cell.chips:
        log(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
            f"found {found}")
        return None
    from portbench.system import System
    cfg, mix, arch = cell.cfg, cell.mix, None
    if not cuda:
        from repro_torch.configs import get_reduced
        from portbench.system import check_widths
        cfg = {**cfg, **cfg["cpu_test"]}
        mix = tiny(mix)
        arch = get_reduced(cfg["name"])
        check_widths(cfg, arch)
    run = Run(cell, cfg, mix, args.device)
    system = System(cfg, mix, args.seed, args.device, arch)
    if cuda:
        torch.cuda.synchronize()
        run.setup_peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start
    return cell, run, system


def main(argv=None, t_start=None) -> int:
    t_start = t_start if t_start is not None else time.perf_counter()
    args = parse(argv)
    cache_dirs()
    made = setup(args, t_start)
    if made is None:
        return 2
    cell, run, system = made
    import torch
    cuda = args.device == "cuda"
    log(f"[setup] {cell.name} seed {args.seed}: {run.setup_s:.3f} s")
    drive(system, run, args.seconds, bool(args.trace))
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips if cuda else 0, "memory_peak_bytes": 0}
    if cuda:
        run.peak_window_bytes = torch.cuda.max_memory_allocated()
        device["memory_peak_bytes"] = max(run.peak_window_bytes,
                                          run.setup_peak_bytes)
    if run.trace is not None:
        run.trace.read()
    metrics = evaluate(run, cell.per_layer if args.trace else cell.end_to_end)
    system.close()
    del system
    from portbench import check
    failed = sum(not r["ok"] for r in run.records)
    t = time.perf_counter()
    picked = check.sample(run.records, run.outputs, run.mix, args.seed)
    gaps = check.reference_gaps(run.cfg, picked, run.outputs, args.seed,
                                args.device, last_logits=run.last_logits)
    correct, checks = check.judge(gaps, failed, cell.limits)
    log(f"[readings] {json.dumps(gaps)}")
    log(f"[check] {len(picked)} invocations against the reference in "
        f"{time.perf_counter() - t:.3f} s")
    bad = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if bad:
        log(f"portbench: forbidden modules loaded: {bad}")
        return 3
    result = {"correct": correct, "attempted": len(run.records),
              "failed": failed, "metrics": metrics, "device": device}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
        log(f"[trace] stopped in {run.trace.stop_s:.3f} s, read in "
            f"{run.trace.read_s:.3f} s, {len(run.trace.kernels)} device "
            f"intervals")
    result["checks"] = checks
    for n in run.notes:
        log(f"[note] {n}")
    paths = {}
    for r in run.records:
        paths[r["path"]] = paths.get(r["path"], 0) + 1
    log(f"[window] {len(run.records)} invocations, paths {paths}, "
        f"{len(run.colds)} cold starts, window {run.window_s:.3f} s")
    lat = sorted((r["latency_s"] for r in run.records), reverse=True)
    log(f"[latency] longest {[round(v, 4) for v in lat[:10]]}")
    log(f"[cold] {[round(c['cold_start_s'], 4) for c in run.colds]}")
    for k, c in checks.items():
        log(f"check {k}: {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
