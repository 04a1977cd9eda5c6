"""cold_start_s: the seconds of every cold start in the window over
their count: each new engine's own ``ServingEngine.cold_start_s``
(host clock around materializing the eager set, the card synchronised
after each component).  Nothing when the window had no cold start."""

SOURCE = "program_span"


def read(run):
    colds = [c["cold_start_s"] for c in run.colds]
    return sum(colds) / len(colds) if colds else None
