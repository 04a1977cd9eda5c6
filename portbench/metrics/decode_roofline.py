"""decode_roofline (%): the least time of the decode attention in the
traced part of the window (each
call over the filled cache slots only, ``counts.decode_call``) over the
device time the profiler gives the decode kernels, graph replays
included.  Kernels read: names holding ``decode_mma`` or
``decode_simt``."""

from portbench.metrics import counts

SOURCE = "device_trace"
KERNELS = ("decode_mma", "decode_simt")


def read(run):
    if run.trace is None:
        return None
    dev_s, n = run.trace.kernel_s(lambda k: any(s in k for s in KERNELS))
    _, _, least, calls = counts.kernel_work(run.cfg, run.batch, run.traced(),
                                            run.mix["prefill_len"])
    if n == 0 or dev_s <= 0:
        return None
    run.note(f"decode_roofline: {n} kernels traced, {calls} calls counted, "
             f"{dev_s:.6f} s on the device, least {least:.6f} s")
    return 100.0 * least / dev_s
