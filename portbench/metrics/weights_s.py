"""weights_s: the ``weights`` group's init seconds per cold start in the
window (drawing the parameters on the card), read as ``compile_s``."""

SOURCE = "program_span"
GROUP = "weights"


def read(run):
    vals = [c["by_group"].get(GROUP, 0.0) for c in run.colds]
    return sum(vals) / len(vals) if vals else None
