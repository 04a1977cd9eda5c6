"""The traced run's device timeline, read from ``torch.profiler``.

The profiler records CPU and CUDA activity over the whole window (the
harness's ``pb.window`` range).  From its raw events (the event tree is
never built: a window holds millions of kernels) this keeps every
device interval (kernels, copies, sets; user ranges projected onto the
device are left out) and, on the dispatcher's thread, the host ops and
the harness's own ``pb.*`` ranges, so an idle gap on the device can be
named by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
import time

SHORT_GAP_NS = 20_000  # gaps under 20 us are counted but not named


class Trace:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.kernels: list[tuple[str, int, int]] = []  # (name, start, end)
        self.window_s = 0.0
        self.busy_s = 0.0
        self.idle_by_host: dict[str, float] = {}

    def prime(self):
        """One empty profiling session, so the window's own pays no start-up:
        the first session of a process takes seconds to set up its
        tracing (12 s on an H100), the next ones do not."""
        self.start()
        self.stop()
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - t

    def read(self):
        """Read the stopped profiler's events (after the window)."""
        t = time.perf_counter()
        self._read(self.prof.profiler.kineto_results.events())
        self.prof = None
        self.read_s = time.perf_counter() - t

    # ---------------------------------------------------------------- read
    def _read(self, events):
        from torch.autograd import DeviceType
        host, window, tid = [], None, None
        for ev in events:
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                if name.startswith("pb.") or _user_annotation(ev):
                    continue
                self.kernels.append((name, ev.start_ns(), ev.end_ns()))
            elif name == "pb.window":
                window = (ev.start_ns(), ev.end_ns())
                tid = ev.start_thread_id()
            else:
                host.append((ev.start_ns(), ev.end_ns(), name,
                             ev.start_thread_id()))
        if window is None:
            return
        w0, w1 = window
        self.window_s = (w1 - w0) / 1e9
        self.kernels = [(n, max(a, w0), min(b, w1))
                        for n, a, b in self.kernels if b > w0 and a < w1]
        busy, gaps, cur = 0, [], w0
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if a > cur:
                gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
        if w1 > cur:
            gaps.append((cur, w1))
        self.busy_s = busy / 1e9
        self._name_gaps(gaps, [h for h in host if h[3] == tid])

    def _name_gaps(self, gaps, host):
        """Idle seconds by the host activity at each gap's middle: the
        harness range around it and the innermost op inside that."""
        ranges = sorted(h for h in host if h[2].startswith("pb."))
        ops = sorted(h for h in host if not h[2].startswith("pb."))
        r_starts = [h[0] for h in ranges]
        o_starts = [h[0] for h in ops]
        for a, b in gaps:
            if b - a < SHORT_GAP_NS:
                label = "gaps under 20 us"
            else:
                mid = (a + b) // 2
                rng = _covering(ranges, r_starts, mid, 50) or "no range"
                op = _covering(ops, o_starts, mid, 200) or "no op"
                label = f"{rng}: {op}"
            self.idle_by_host[label] = (self.idle_by_host.get(label, 0.0)
                                        + (b - a) / 1e9)

    # ------------------------------------------------------------- queries
    def kernel_s(self, match) -> tuple[float, int]:
        """Device seconds and count of the kernels whose name ``match``
        accepts."""
        t, n = 0, 0
        for name, a, b in self.kernels:
            if match(name):
                t += b - a
                n += 1
        return t / 1e9, n

    def breakdown(self, top: int = 10) -> dict:
        by: dict[str, float] = {}
        for name, a, b in self.kernels:
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _covering(spans, starts, t, back):
    """The name of the latest-starting of the ``back`` spans that start
    before ``t`` which is still open at ``t`` (the innermost), or ''."""
    i = bisect.bisect_right(starts, t)
    for s, e, n, _ in reversed(spans[max(0, i - back):i]):
        if e > t:
            return n
    return ""


def _user_annotation(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else False
