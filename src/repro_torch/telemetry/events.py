"""Structured event log: typed JSONL events + run provenance (port of
``repro.telemetry.events``: the same event types, required fields and line
format, so a log written by either package reads in the other).

Every subsystem emits typed events through an :class:`EventLog`, and
``telemetry.report.RunReport`` folds a log back into one comparable
``RUN_REPORT.json``.

Events are append-only JSON lines ``{"event": type, "seq": n, "t": wall,
...fields}``.  The event *types* are closed (:data:`EVENT_TYPES` — unknown
types are a bug, not a forward-compat feature) but each type's payload is
open beyond its :data:`REQUIRED_FIELDS`, so emitters can attach context
without schema churn.

The default sink is *null*: an ``EventLog()`` with no path and no buffer is
disabled, ``emit`` returns immediately without touching its arguments, and
every integration point (Trainer, launchers) treats that as "telemetry
off" — the step loop adds no launch, sync or transfer and history stays
bit-identical (tested).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

SCHEMA_VERSION = 1

EVENT_TYPES = frozenset({
    "run_start",      # provenance: git sha, torch/CUDA versions, device, config hash
    "stage_start",    # mixed-batch stage boundary
    "step",           # logged training step: metrics + span-timed step seconds
    "span",           # one closed span: name, seconds, count
    "trust_ratios",   # per-layer trust-ratio/norm summaries at a logged step
    "checkpoint",     # checkpoint written (async saves add snapshot/write timings)
    "resume",         # training resumed from a persisted checkpoint
    "serve_request",  # one request's terminal lifecycle record
    "serve_stats",    # aggregate serving stats for one generate() run
    "serve_shed",     # admission control rejected a request (reason says why)
    "serve_timeout",  # request blew its latency budget (queue or decode)
    "serve_retry",    # transient failure: request requeued for another attempt
    "serve_quarantine",  # corrupted slot withheld from the free list
    "serve_degraded", # stall watchdog toggled degraded admissions
    "serve_drain",    # graceful drain started: admissions stopped
    "bench_result",   # one benchmark suite's result
    "nonfinite_step", # the guard skipped step(s): non-finite loss/grads
    "rollback",       # supervisor restored an earlier checkpoint after a trip
    "preempt",        # SIGTERM/SIGINT caught: grace-window save + clean stop
    "run_end",        # terminal event (carries an explicit status)
})

# minimum payload per type; extra fields are allowed and preserved
REQUIRED_FIELDS: Dict[str, tuple] = {
    "run_start": ("provenance",),
    "stage_start": ("stage", "name"),
    "step": ("step",),
    "span": ("name", "seconds"),
    "trust_ratios": ("step", "layers"),
    "checkpoint": ("step", "path"),
    "resume": ("step", "path"),
    "serve_request": ("rid",),
    "serve_stats": (),
    "serve_shed": ("rid", "reason"),
    "serve_timeout": ("rid",),
    "serve_retry": ("rid", "attempt"),
    "serve_quarantine": ("slot", "rid"),
    "serve_degraded": ("active",),
    "serve_drain": ("queued", "in_flight"),
    "bench_result": ("name",),
    "nonfinite_step": ("step", "count"),
    "rollback": ("step", "from_step", "reason"),
    "preempt": ("step", "signal"),
    "run_end": (),
}


def _jsonable(obj: Any):
    """JSON encoder default: numpy scalars/arrays and paths degrade cleanly."""
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, Path):
        return str(obj)
    if hasattr(obj, "tolist"):  # tensors
        return obj.tolist()
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}")


def validate_event(ev: Dict[str, Any]) -> None:
    """Raise ValueError unless ``ev`` is a well-formed typed event."""
    etype = ev.get("event")
    if etype not in EVENT_TYPES:
        raise ValueError(
            f"unknown event type {etype!r}; known: {sorted(EVENT_TYPES)}"
        )
    missing = [f for f in REQUIRED_FIELDS[etype] if f not in ev]
    if missing:
        raise ValueError(f"event {etype!r} missing required fields {missing}")


class EventLog:
    """Append-only JSONL event emitter with a zero-overhead null default.

    Three modes:

    * ``EventLog()`` — **null sink** (default everywhere): ``enabled`` is
      False and ``emit`` is a no-op that never serializes its arguments.
    * ``EventLog(path)`` / ``EventLog.to_dir(dir)`` — append JSON lines to
      ``path`` (created, parents included), flushed per event.
    * ``EventLog.memory()`` — buffer events in ``self.events`` (tests,
      benchmark sweeps that fold straight into a report).

    Every emitted event is validated against :data:`EVENT_TYPES` /
    :data:`REQUIRED_FIELDS` and stamped with a monotonically increasing
    ``seq`` and a wall-clock ``t``.
    """

    def __init__(self, path: Optional[Union[str, Path]] = None,
                 *, buffer: bool = False):
        self.path = Path(path) if path is not None else None
        self.events: List[Dict[str, Any]] = []
        self._buffer = buffer
        self._seq = 0
        self._fh = None
        # emit must be thread-safe: the AsyncCheckpointer's background
        # writer emits checkpoint events while the step loop emits its own
        self._lock = threading.Lock()

    @classmethod
    def to_dir(cls, directory: Union[str, Path],
               name: str = "events.jsonl") -> "EventLog":
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        return cls(d / name)

    @classmethod
    def memory(cls) -> "EventLog":
        return cls(buffer=True)

    @property
    def enabled(self) -> bool:
        return self.path is not None or self._buffer

    def emit(self, event: str, **fields) -> Optional[Dict[str, Any]]:
        """Validate, stamp and write one event; no-op when disabled."""
        if not self.enabled:
            return None
        with self._lock:
            ev = {"event": event, "seq": self._seq, "t": time.time(), **fields}
            validate_event(ev)
            self._seq += 1
            if self._buffer:
                self.events.append(ev)
            if self.path is not None:
                if self._fh is None:
                    self.path.parent.mkdir(parents=True, exist_ok=True)
                    self._fh = self.path.open("a")
                self._fh.write(json.dumps(ev, default=_jsonable) + "\n")
                self._fh.flush()
            return ev

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: Union[str, Path]) -> List[Dict[str, Any]]:
    """Load and validate a JSONL event log (schema round-trip)."""
    events = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        ev = json.loads(line)
        validate_event(ev)
        events.append(ev)
    return events


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------

def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=10,
        )
        return out.stdout.strip() if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def config_hash(*configs) -> str:
    """Stable sha256 over one or more (frozen-dataclass) configs."""
    blobs = []
    for c in configs:
        if c is None:
            continue
        d = dataclasses.asdict(c) if dataclasses.is_dataclass(c) else c
        blobs.append(json.dumps(d, sort_keys=True, default=str))
    return hashlib.sha256("|".join(blobs).encode()).hexdigest()[:16]


def run_provenance(*, timestamp: Optional[float] = None, device=None, mesh=None,
                   configs: tuple = ()) -> Dict[str, Any]:
    """The provenance block every run/report carries (MLPerf-style).

    ``timestamp`` is passed in by the caller (a sweep's suites share one);
    ``device`` is the run's torch device (default: ``cuda`` when a card is
    present, else ``cpu``) and names ``backend``, ``device_kind`` (the
    card's name) and ``device_count``; ``configs`` are hashed, not
    embedded, so reports stay diffable; ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh` or None) is recorded as
    ``{axis: size}``.  The keys the JAX package's provenance shares with
    this one (``git_sha``, ``config_hash``, ``device_kind``, ``mesh``, ...)
    keep its names.
    """
    import torch  # deferred: the schema and the log need no torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    on_card = device.type == "cuda"
    prov: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "timestamp": time.time() if timestamp is None else float(timestamp),
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": device.type,
        "device_kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
    }
    if mesh is not None:
        prov["mesh"] = {str(k): int(v) for k, v in mesh.shape.items()}
    if configs:
        prov["config_hash"] = config_hash(*configs)
    return prov
