"""Closed-loop training as ``drivers/train.py`` (its set-up, its window and
the numbers its check compares), checked and calibrated against the
blocked reference (``reference/blocked.py``): at upstream V18's batch 24
``reference/train.py``'s whole-batch micro-step would keep 88 GB of
attention activations, more than the card holds.  ``drivers/train.py``'s
check runs the reference's micro-step through ``reference.train.
micro_step``, read at each call; the blocked one stands there while this
driver checks."""

from __future__ import annotations

import contextlib

from benchmark.drivers import train as base
from benchmark.reference import blocked
from benchmark.reference import train as ref_train

setup = base.setup
window = base.window


@contextlib.contextmanager
def _blocked_reference():
    whole = ref_train.micro_step
    ref_train.micro_step = blocked.micro_step
    try:
        yield
    finally:
        ref_train.micro_step = whole


def check(run, state) -> list[dict]:
    with _blocked_reference():
        return base.check(run, state)


def calibrate(run, state, control: str | None, faults: bool) -> dict:
    with _blocked_reference():
        return base.calibrate(run, state, control, faults)
