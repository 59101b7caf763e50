"""``scan``: a loop over time, the port's ``jax.lax.scan``.

``scan(step, carry, xs, dim=d, out_dim=o)`` runs ``carry, y =
step(carry, *(x.select(d, t) for x in xs))`` for every ``t`` along
dimension ``d`` of the ``xs`` and returns the last carry and the ``y``
stacked along dimension ``o`` (None where the step returns None): a Python
loop, the aten ops of each step in order, then one ``torch.stack``.

A counter may stand in for the loop (:func:`counted_by`): the dry-run
(``launch/dryrun.py``) counts a few steps and scales them to the length,
so its trace of a long prompt costs what a short one does.  The layers
call :func:`scan` alone and know nothing of it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

_state = threading.local()


def scan(step: Callable, carry, xs: Sequence[torch.Tensor], *, dim: int = 0,
         out_dim: int = 0) -> Tuple[object, Optional[torch.Tensor]]:
    """The last carry of ``step`` over dimension ``dim`` of ``xs``, and its
    outputs stacked along ``out_dim``."""
    xs = tuple(xs)
    counter = getattr(_state, "counter", None)
    if counter is not None:
        out = counter(step, carry, xs, dim, out_dim)
        if out is not None:
            return out
    ys = []
    for t in range(xs[0].shape[dim]):
        carry, y = step(carry, *(x.select(dim, t) for x in xs))
        if y is not None:
            ys.append(y)
    return carry, (torch.stack(ys, out_dim) if ys else None)


@contextlib.contextmanager
def counted_by(counter: Optional[Callable]):
    """Within the block ``counter(step, carry, xs, dim, out_dim)`` runs in
    place of each :func:`scan` on this thread; where it returns None the
    loop runs as written."""
    prev = getattr(_state, "counter", None)
    _state.counter = counter
    try:
        yield
    finally:
        _state.counter = prev
