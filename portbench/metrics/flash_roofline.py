"""flash_roofline (%): the least time of the prefill attention in the
traced part of the window (each call the larger of its operations at
the bf16 peak and its bytes at HBM bandwidth, ``counts.flash_call``)
over the device time the profiler gives the flash kernels there.
Kernels read: names holding ``flash_fwd`` (``flash_fwd_wgmma``,
``flash_fwd_simt``)."""

from portbench.metrics import counts

SOURCE = "device_trace"
KERNELS = ("flash_fwd",)


def read(run):
    if run.trace is None:
        return None
    dev_s, n = run.trace.kernel_s(lambda k: any(s in k for s in KERNELS))
    least, calls, _, _ = counts.kernel_work(run.cfg, run.batch, run.traced(),
                                            run.mix["prefill_len"])
    if n == 0 or dev_s <= 0:
        return None
    run.note(f"flash_roofline: {n} kernels traced, {calls} calls counted, "
             f"{dev_s:.6f} s on the device, least {least:.6f} s")
    return 100.0 * least / dev_s
