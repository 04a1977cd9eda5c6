"""cold_share (%): the share of the window's invocations whose
``EnginePool.dispatch`` returned the path ``cold`` (a cold start served
it), of all that returned."""

SOURCE = "program_counter"


def read(run):
    done = [r for r in run.records if r["path"] is not None]
    if not done:
        return None
    return 100.0 * sum(r["path"] == "cold" for r in done) / len(done)
