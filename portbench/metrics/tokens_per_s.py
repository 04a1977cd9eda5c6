"""tokens_per_s: tokens generated by every invocation that completed,
over the window: from its open to the later of its nominal end and the
last completion (a closed loop ends with its last invocation; an open
loop serves every invocation due in it)."""

SOURCE = "host_clock"


def read(run):
    toks = sum(run.batch * r["new_tokens"] for r in run.records if r["ok"])
    return toks / run.window_s if run.window_s > 0 else None
