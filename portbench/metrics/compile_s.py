"""compile_s: the ``compile`` group's init seconds per cold start in the
window (``ServingEngine.registry.report()["by_group"]``, read after the
request the new engine served: each entry's warm-up at the engine's
shapes and the decode step's CUDA-graph capture)."""

SOURCE = "program_span"
GROUP = "compile"


def read(run):
    vals = [c["by_group"].get(GROUP, 0.0) for c in run.colds]
    return sum(vals) / len(vals) if vals else None
