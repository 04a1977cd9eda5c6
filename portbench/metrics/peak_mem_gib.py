"""peak_mem_gib: the most device memory the program held at once in the
window (``torch.cuda.max_memory_allocated``, reset when the window
opens), in GiB: the paper's memory metric."""

SOURCE = "device_trace"


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2**30
