"""``expert_read_share``: the share of the MoE experts the traced
``generate`` serves' decode steps read, from the ``serve`` span's
``moe_experts_read`` and ``moe_expert_slots``; nothing where no span
carries them."""

import pytest

from portbench import bench
from repro_torch.obs import tracing

MS = 1_000_000  # ns
T0 = 1_800_000_000 * 10**9  # some Unix-epoch time, in ns
OPEN = "olmoe-1b-7b.serve_steady"
NAME = "expert_read_share.open"


@pytest.fixture
def tracer():
    tr = tracing.get_tracer()
    tracing.configure_tracing(enabled=False)
    tr.clear()
    yield tr
    tr.clear()


def _run():
    cell = bench.Cell(OPEN)
    run = bench.Run(cell, cell.cfg, cell.mix, "cuda")
    run.trace = object()  # a traced run: the readers read the tracer
    return cell, run


def _serve(tr, a_ms, steps, entry="generate", **attrs):
    tr.record(tracing.Span(
        name="serve", trace_id="t", span_id=f"serve@{a_ms}", parent_id=None,
        start_ns=T0 + a_ms * MS, end_ns=T0 + (a_ms + 900) * MS,
        attrs=dict(entry=entry, batch=4, prompt_len=1024,
                   new_tokens=steps + 1, prefill_device_ms=110.0,
                   decode_device_ms=6.5 * steps, decode_steps=steps,
                   **attrs)))


def test_the_metric_is_the_olmoe_cells_and_reads_a_counter():
    cell = bench.Cell(OPEN)
    assert NAME in {m["name"] for m in cell.per_layer}
    assert cell.readers[NAME].SOURCE == "program_counter"
    assert NAME not in {m["name"] for m in
                        bench.Cell("granite-8b.fleet_zipf").per_layer}


def test_share_of_experts_read_over_the_traced_serves(tracer):
    slots = 64 * 16 * 128
    _serve(tracer, 0, 128, moe_experts_read=21000, moe_expert_slots=slots)
    _serve(tracer, 2000, 128, moe_experts_read=22000,
           moe_expert_slots=slots)
    # a score serve and an untraced run's spans are not read
    _serve(tracer, 4000, 0, entry="score", moe_experts_read=5,
           moe_expert_slots=5)
    cell, run = _run()
    got = cell.readers[NAME].read(run)
    assert got == pytest.approx(100.0 * 43000 / (2 * slots))
    mine = [m for m in cell.per_layer if m["name"] == NAME]
    assert bench.evaluate(run, mine)[NAME] == {"value": got, "unit": "%"}


def test_nothing_to_read_without_the_attribute(tracer):
    _serve(tracer, 0, 128)  # a program without the counter
    cell, run = _run()
    assert cell.readers[NAME].read(run) is None
    assert NAME not in bench.evaluate(run, [m for m in cell.per_layer
                                            if m["name"] == NAME])


def test_nothing_to_read_without_a_trace(tracer):
    _serve(tracer, 0, 128, moe_experts_read=10, moe_expert_slots=100)
    cell, run = _run()
    run.trace = None
    assert cell.readers[NAME].read(run) is None
