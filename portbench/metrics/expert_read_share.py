"""expert_read_share: the share of the MoE experts that the traced
``generate`` serves' decode steps read: 100 x the sum of their
``moe_experts_read`` (the program's device counter of experts its
expert-sparse kernels did not skip) over the sum of their
``moe_expert_slots`` (experts x MoE layers x decode steps).  None where
no span carries them: a program without the counter, or a decode step
that does not run those kernels."""

from portbench.metrics import spans

SOURCE = "program_counter"


def read(run):
    got = [s for s in spans.serves(run) if "moe_expert_slots" in s.attrs]
    slots = sum(s.attrs["moe_expert_slots"] for s in got)
    if slots == 0:
        return None
    return 100.0 * sum(s.attrs["moe_experts_read"] for s in got) / slots
