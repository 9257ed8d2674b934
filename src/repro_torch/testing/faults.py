"""Deterministic fault injection for the execution engine (port of
``repro.testing.faults``).

The executor calls the module-level hooks below:

    on_transfer(wave, rows)   before every host->device wave transfer
                              (the streamed wave loop ``plans._stream``)
    on_exchange()             at every shuffle exchange
                              (``db.distributed.shuffle_by_key``)

With no plan installed both hooks are no-ops (one attribute read).  Tests
install a :class:`FaultPlan` with :func:`inject` to fail chosen
occurrences deterministically:

    with faults.inject(faults.FaultPlan(transfer_calls={5})) as fp:
        result = compiled(tables)       # 6th transfer raises once
    assert fp.consumed()                # the fault actually fired

Every injected failure raises :class:`TransferFault`.  The wave loop
re-ships the failed wave in place (completed waves are never re-streamed
and never filed twice; assert on ``fp.log``); a fault that exhausts the
in-loop retries propagates annotated with the halved wave size
(``wave_chunks``) so :func:`repro_torch.db.plans.run_plan` can re-lower
with a smaller wave.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable


class TransferFault(RuntimeError):
    """An injected (or, in principle, real) host<->device transfer failure.
    When the fault escapes the streamed executor's in-loop wave retries it
    is annotated: ``wave_chunks`` is the HALVED wave size (global chunk
    slots) the retry controller should re-lower with, and ``at_minimum``
    marks a schedule already at one chunk slot per shard, where no smaller
    wave exists and the fault is terminal."""

    wave_chunks: int | None = None
    at_minimum: bool = False


@dataclasses.dataclass
class FaultPlan:
    """Deterministic injection schedule.

    transfer_calls   global occurrence indices of ``on_transfer`` calls
                     (0-based, counted across phases and retries) that
                     fail ONCE each: the transient-fault model.
    exchange_calls   global occurrence indices of ``on_exchange`` calls
                     that fail once each.
    transfer_rows_over   when set, EVERY transfer of more than this many
                     rows fails (persistent): only a smaller wave (the
                     retry controller's halving) succeeds.
    """

    transfer_calls: Iterable[int] = ()
    exchange_calls: Iterable[int] = ()
    transfer_rows_over: int | None = None

    def __post_init__(self):
        self._transfer_pending = set(self.transfer_calls)
        self._exchange_pending = set(self.exchange_calls)
        self._n_transfer = 0
        self._n_exchange = 0
        #: every on_transfer call as (occurrence, wave, rows, failed).
        self.log: list = []

    def on_transfer(self, wave: int, rows: int) -> None:
        i = self._n_transfer
        self._n_transfer += 1
        fail = i in self._transfer_pending
        self._transfer_pending.discard(i)
        if (self.transfer_rows_over is not None
                and rows > self.transfer_rows_over):
            fail = True
        self.log.append((i, wave, rows, fail))
        if fail:
            raise TransferFault(
                f"injected transfer fault: occurrence {i}, wave {wave}, "
                f"{rows} rows")

    def on_exchange(self) -> None:
        i = self._n_exchange
        self._n_exchange += 1
        if i in self._exchange_pending:
            self._exchange_pending.discard(i)
            raise TransferFault(f"injected exchange fault: occurrence {i}")

    def consumed(self) -> bool:
        """Every one-shot fault fired (the test exercised what it meant
        to)."""
        return not self._transfer_pending and not self._exchange_pending


#: the installed plan (None = hooks are no-ops); single-threaded harness
#: state, like the kernels' launch counters.
_ACTIVE: FaultPlan | None = None


def on_transfer(wave: int, rows: int) -> None:
    if _ACTIVE is not None:
        _ACTIVE.on_transfer(wave, rows)


def on_exchange() -> None:
    if _ACTIVE is not None:
        _ACTIVE.on_exchange()


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Install ``plan`` for the with-block (exclusive: nesting raises,
    since overlapping schedules would race their occurrence counters)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a FaultPlan is already installed")
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None
