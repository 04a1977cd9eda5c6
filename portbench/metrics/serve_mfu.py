"""serve_mfu (%): model operations of every token served in the traced
part of the window (prefills, decode steps and scores, counted by
``counts``) over that part's length times the card's bf16 peak.  The
whole step's share of the peak: it bounds what any kernel's gain can
show."""

from portbench.metrics import counts

SOURCE = "device_trace"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    flops = sum(counts.served_flops(run.cfg, run.batch, r["entry"],
                                    r["prompt_len"], r["new_tokens"])
                for r in run.traced() if r["ok"])
    return 100.0 * flops / (run.trace.window_s * counts.PEAK_BF16_FLOPS)
