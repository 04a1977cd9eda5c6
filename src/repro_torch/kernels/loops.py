"""Python loops over time: the plain RG-LRU scan's and the mLSTM / sLSTM
scans'.

``time_loop(step, state, S)`` runs ``step`` for t = 0..S-1 and stacks
its outputs on dim 1.  Under ``time_loops(repeat)`` (the dry-run's
counting, ``repro_torch.launch.dryrun``) a loop runs loop-aware instead:
its first step, then one more inside ``repeat(S - 1)``, a context that
counts what runs in it S - 1 times; the other steps' outputs are that
step's.  The autograd nodes the repeated step made run their backward
inside ``repeat(S - 1)`` too, so a train step's backward through the
loop is counted S - 1 times as well.  The autograd engine sums the
per-step gradients of a tensor made before the loop (one the steps
slice or share) between nodes, where no hook sees it: the full loop
adds S of them, the loop-aware one two, so each such gradient of the
repeated step is added to itself once more inside ``repeat(S - 2)``,
an add of the same bytes.  The engine's sums of gradients made inside
the steps (a tensor a step uses twice, the state a step hands on) are
still counted once.  Values are not those of the full loop (the
dry-run runs on the meta device, where there are none).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_loops = threading.local()


@contextlib.contextmanager
def time_loops(repeat):
    """Run ``time_loop`` loop-aware in this thread with ``repeat`` (a
    factory of context managers taking a count); None runs every
    step."""
    prev = getattr(_loops, "repeat", None)
    _loops.repeat = repeat
    try:
        yield
    finally:
        _loops.repeat = prev


def time_loop(step, state, S):
    """(state, outs): ``step(state, t) -> (state, out)`` run for t =
    0..S-1, and its outputs stacked on dim 1."""
    repeat = getattr(_loops, "repeat", None)
    if repeat is None or S <= 2:
        outs = []
        for t in range(S):
            state, out = step(state, t)
            outs.append(out)
        return state, torch.stack(outs, dim=1)
    grad = torch.is_grad_enabled()
    before = _sequence_mark() if grad else None
    state, first = step(state, 0)
    mark = _sequence_mark() if grad else None
    with repeat(S - 1):  # steps 1..S-1 are one step's ops S - 1 times
        state, last = step(state, 1)
    if grad:
        _repeat_backward(repeat, S - 1, mark, (state, last), before)
    rest = last[:, None].expand(last.shape[:1] + (S - 1,) + last.shape[1:])
    return state, torch.cat([first[:, None], rest], dim=1)


def _sequence_mark() -> int:
    """The sequence number an autograd node made now would get (the
    probe's ops are kept from dispatch modes: no counter sees them)."""
    with torch._C._DisableTorchDispatch():
        probe = torch.zeros((), requires_grad=True).mul(1)
    return probe.grad_fn._sequence_nr()


def _repeat_backward(repeat, n, mark, outputs, before):
    """Run the backward of every autograd node made after ``mark`` that
    ``outputs`` reach (the repeated step's) inside ``repeat(n)``, and
    count the engine's sums of their gradients for nodes made before
    ``before`` (the loop) n - 1 times more."""
    roots = [t.grad_fn for t in _tensors(outputs) if t.grad_fn is not None]
    seen, todo, nodes = set(), list(roots), []
    while todo:
        node = todo.pop()
        if node is None or node in seen or node._sequence_nr() <= mark \
                or type(node).__name__ == "AccumulateGrad":
            continue
        seen.add(node)
        nodes.append(node)
        todo.extend(nxt for nxt, _ in node.next_functions)
    active = []

    def enter(*_):
        active.append(repeat(n))
        active[-1].__enter__()

    def leave(*_):
        active.pop().__exit__(None, None, None)

    def summed(node):
        into = [nxt is not None and nxt not in seen and (
            type(nxt).__name__ == "AccumulateGrad"
            or nxt._sequence_nr() < before) for nxt, _ in node.next_functions]

        def add(grads, _):
            with repeat(n - 1):
                for g, hit in zip(grads, into):
                    if hit and g is not None:
                        g + g
        return add
    for node in nodes:
        node.register_prehook(enter)
        node.register_hook(leave)
        if n > 1:
            node.register_hook(summed(node))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []
