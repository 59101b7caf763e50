"""Deterministic fault injection for the serving reliability harness.

A copy of ``repro.serve.faults`` (host Python; nothing changed).

The serving twin of ``train/faults.py``: a :class:`ServeFaultInjector` is a
pure state machine the ``ContinuousEngine`` consults at fixed points in a
request's lifecycle, so the same spec list over the same workload produces
the same fault sequence — and therefore the same terminal-state counts —
on every replay (``reset()`` rewinds the fired-set for a second run).

Three kinds, keyed like the training injector by a **deterministic
ordinal**, never by wall time:

* ``sample_nan`` — keyed by request id: the request's first sampled token
  of the current attempt is reported non-finite.  The engine treats it as
  a transient failure: the slot is freed immediately and the request is
  requeued with a bounded retry/backoff budget (exhausted retries surface
  as ``FAILED``, never as a silent drop).
* ``slot_corrupt`` — keyed by request id: the slot's KV state is reported
  corrupted after prefill.  Same retry path as ``sample_nan``, but the
  slot itself is **quarantined** — evicted and withheld from the free
  list for a cool-down — before the request is requeued.
* ``decode_stall`` — keyed by the *decode-step ordinal within the current
  generate run*: the step blocks for ``stall_s`` seconds, the signature
  of a hiccuping accelerator.  Drives the engine's stall watchdog
  (degraded-mode admission caps + ``serve_degraded`` event).

``once=True`` (default) faults fire a single time — the retry succeeds,
proving the recovery path; ``once=False`` faults re-fire on every attempt
— the retry budget exhausts, proving the failure surface.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

SERVE_FAULT_KINDS = ("sample_nan", "slot_corrupt", "decode_stall")


@dataclasses.dataclass(frozen=True)
class ServeFaultSpec:
    """One planned serving fault.

    ``at`` is the request id for ``sample_nan``/``slot_corrupt`` and the
    in-run decode-step ordinal for ``decode_stall``; ``at < 0`` fires on
    every ordinal (persistent fault).  ``stall_s`` is the injected stall
    duration (``decode_stall`` only).  ``once=True`` fires a non-negative
    ``at`` a single time even when the ordinal recurs (a retried request,
    a replayed step).
    """

    kind: str
    at: int
    stall_s: float = 0.05
    once: bool = True

    def __post_init__(self):
        if self.kind not in SERVE_FAULT_KINDS:
            raise ValueError(
                f"unknown serve fault kind {self.kind!r}; "
                f"one of {SERVE_FAULT_KINDS}"
            )
        if self.stall_s < 0:
            raise ValueError(f"stall_s must be >= 0, got {self.stall_s}")


class ServeFaultInjector:
    """Deterministic, replayable fault source for the continuous engine."""

    def __init__(self, faults: Iterable[ServeFaultSpec]):
        self.faults: Tuple[ServeFaultSpec, ...] = tuple(faults)
        self._fired: Dict[int, int] = {}  # spec index -> fire count

    def _fire(self, idx: int, spec: ServeFaultSpec) -> bool:
        if spec.at >= 0 and spec.once and self._fired.get(idx, 0):
            return False
        self._fired[idx] = self._fired.get(idx, 0) + 1
        return True

    def fire_request(self, rid: int) -> Optional[str]:
        """The fault kind (if any) striking request ``rid``'s current
        attempt.  ``slot_corrupt`` outranks ``sample_nan`` when both match
        (the stronger failure decides the slot's fate); at most one fires
        per call so counts stay exact."""
        hit: Optional[Tuple[int, ServeFaultSpec]] = None
        for idx, f in enumerate(self.faults):
            if f.kind == "decode_stall" or (f.at >= 0 and f.at != rid):
                continue
            if f.at >= 0 and f.once and self._fired.get(idx, 0):
                continue
            if hit is None or (f.kind == "slot_corrupt"
                               and hit[1].kind != "slot_corrupt"):
                hit = (idx, f)
        if hit is None:
            return None
        self._fire(*hit)
        return hit[1].kind

    def stall_s(self, step_ordinal: int) -> float:
        """Total injected stall for decode step ``step_ordinal`` (0 when
        no ``decode_stall`` spec matches)."""
        total = 0.0
        for idx, f in enumerate(self.faults):
            if f.kind != "decode_stall":
                continue
            if f.at >= 0 and f.at != step_ordinal:
                continue
            if self._fire(idx, f):
                total += f.stall_s
        return total

    def fire_counts(self) -> Dict[str, int]:
        """Fires so far per kind (diagnostics / replay assertions)."""
        out: Dict[str, int] = {}
        for idx, n in self._fired.items():
            kind = self.faults[idx].kind
            out[kind] = out.get(kind, 0) + n
        return out

    def reset(self) -> None:
        """Rewind the fired-set: the next run replays the same sequence."""
        self._fired.clear()


def parse_fault_specs(text: str) -> List[ServeFaultSpec]:
    """Parse a CLI fault list: ``kind@at[:persist][:stall=SECONDS]``
    entries separated by commas.

    >>> [f.kind for f in parse_fault_specs("sample_nan@1,slot_corrupt@2:persist")]
    ['sample_nan', 'slot_corrupt']
    >>> parse_fault_specs("decode_stall@3:stall=0.2")[0].stall_s
    0.2
    """
    specs: List[ServeFaultSpec] = []
    for entry in filter(None, (e.strip() for e in text.split(","))):
        parts = entry.split(":")
        head = parts[0]
        if "@" not in head:
            raise ValueError(
                f"bad fault spec {entry!r}: expected kind@ordinal"
            )
        kind, at = head.split("@", 1)
        once = True
        stall = 0.05
        for opt in parts[1:]:
            if opt == "persist":
                once = False
            elif opt == "once":
                once = True
            elif opt.startswith("stall="):
                stall = float(opt[len("stall="):])
            else:
                raise ValueError(f"bad fault spec option {opt!r} in {entry!r}")
        specs.append(ServeFaultSpec(kind=kind, at=int(at), stall_s=stall,
                                    once=once))
    return specs
