"""The control comes out not correct, at each cell's own size, on the
card: the reference computed with every matmul in float8 e4m3 (the next
precision below the served bf16) picks tokens whose gap, read against
the float32 reference on the same prompts and served tokens, exceeds
the cell's limit, where the program's own stays inside it.

Marked ``cuda``: a reduced configuration rounds too little for the
control to show (on the CPU its gaps read 0 to 0.02, under any limit).
Run on the card with ``python -m pytest -q -m cuda portbench/tests``.
"""

import pytest

from portbench import bench, check

CELLS = ["granite-8b.fleet_zipf", "olmoe-1b-7b.serve_steady"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_fails_the_limit(card, cell):
    args = bench.parse(["--workload", cell, "--seed", "2147483901",
                        "--seconds", "8"])
    c, run, system = bench.setup(args, 0.0)
    bench.drive(system, run, 8.0, False)
    system.close()
    picked = check.sample(run.records, run.outputs, run.mix, args.seed)
    gaps = check.reference_gaps(run.cfg, picked, run.outputs, args.seed,
                                "cuda", last_logits=run.last_logits,
                                control=True)
    control = {k[:-len("_control")]: v for k, v in gaps.items()
               if k.endswith("_control")}
    print(cell, gaps)
    assert check.judge(gaps, 0, c.limits)[0]
    assert not check.judge(control, 0, c.limits)[0]
