"""RunReport: fold an event log (+ ``BENCH_*.json``) into one comparable
report with an MLPerf-style regression gate (port of
``repro.telemetry.report``: the same sections and keys, so a report written
by either package loads and compares in the other).

The Nado et al. "reality check" point (PAPERS.md): a large-batch optimizer
claim is only credible when the metrics travel *with* their provenance —
what was tuned, what schedule ran, what hardware.  ``RUN_REPORT.json`` is
that unit here.  ``RunReport.from_events`` replays a structured event log
(``telemetry.events``) into sections — provenance, train (steps, final
metrics, span-timed step seconds), trust-ratio summaries, serve, bench —
and ``compare(baseline, tolerances)`` is the regression gate CI runs
against a committed baseline: presence checks for schema/sections, relative
tolerances for numbers (the reframe-mlperf idiom — a benchmark that cannot
fail is a demo, not a gate).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from repro_torch.telemetry.events import (
    SCHEMA_VERSION,
    EventLog,
    _jsonable,
    read_events,
)

_MISSING = object()


def _get_path(d: Any, dotted: str):
    """Walk ``a.b.c`` through nested dicts; _MISSING when absent."""
    cur = d
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return _MISSING
        cur = cur[part]
    return cur


@dataclasses.dataclass
class Check:
    key: str
    status: str  # ok | missing | mismatch | regressed
    detail: str = ""


@dataclasses.dataclass
class CompareResult:
    ok: bool
    checks: List[Check]

    def failures(self) -> List[Check]:
        return [c for c in self.checks if c.status != "ok"]

    def render(self) -> str:
        lines = [f"{c.status:10s} {c.key}  {c.detail}".rstrip()
                 for c in self.checks]
        verdict = "PASS" if self.ok else "FAIL"
        return "\n".join(lines + [f"compare: {verdict} "
                                  f"({len(self.failures())} failures)"])


class RunReport:
    """One run's folded report: ``.report`` is a plain JSON-ready dict."""

    def __init__(self, report: Dict[str, Any]):
        self.report = report

    # ------------------------------------------------------------------
    @classmethod
    def from_events(
        cls,
        events: Union[str, Path, EventLog, List[dict]],
        *,
        bench_dir: Optional[Union[str, Path]] = None,
    ) -> "RunReport":
        """Fold an event log (path / memory EventLog / event list) into a
        report; ``bench_dir`` additionally folds every ``BENCH_*.json``
        found there (each keyed by its suffix, provenance-stamped or not).
        """
        if isinstance(events, EventLog):
            evs = list(events.events)
        elif isinstance(events, (str, Path)):
            evs = read_events(events)
        else:
            evs = list(events)

        by_type: Dict[str, List[dict]] = {}
        for ev in evs:
            by_type.setdefault(ev["event"], []).append(ev)

        report: Dict[str, Any] = {
            "schema_version": SCHEMA_VERSION,
            "events": {
                "count": len(evs),
                "types": {k: len(v) for k, v in sorted(by_type.items())},
            },
        }
        if by_type.get("run_start"):
            report["provenance"] = by_type["run_start"][0].get("provenance", {})
        if by_type.get("run_end"):
            end = by_type["run_end"][-1]
            report["run_end"] = {k: v for k, v in end.items()
                                 if k not in ("event", "seq")}
            if "status" in end:
                report["status"] = end["status"]

        steps = by_type.get("step", [])
        if steps:
            last = steps[-1]
            train: Dict[str, Any] = {
                "logged_steps": len(steps),
                "steps": int(last["step"]),
                "final": dict(last.get("metrics", {})),
            }
            if "examples_seen" in last:
                train["examples_seen"] = int(last["examples_seen"])
            if "wall_s" in last:
                train["wall_s"] = float(last["wall_s"])
            report["train"] = train

        spans = by_type.get("span", [])
        if spans:
            agg: Dict[str, List[tuple]] = {}
            for ev in spans:
                agg.setdefault(ev["name"], []).append(
                    (float(ev["seconds"]), int(ev.get("count", 1))))
            report["spans"] = {
                name: {
                    "count": int(sum(c for _, c in obs)),
                    "total_s": float(sum(s for s, _ in obs)),
                    "mean_s": float(sum(s for s, _ in obs)
                                    / max(sum(c for _, c in obs), 1)),
                    "max_s": float(max(s / max(c, 1) for s, c in obs)),
                }
                for name, obs in agg.items()
            }

        trust = by_type.get("trust_ratios", [])
        if trust:
            last = trust[-1]
            hist = np.zeros(0)
            edges: List[float] = []
            for ev in trust:
                h = ev.get("hist", {})
                counts = np.asarray(h.get("counts", []), np.int64)
                if counts.size:
                    hist = counts if hist.size == 0 else hist + counts
                    edges = h.get("edges", edges)
            report["trust_ratios"] = {
                "steps_recorded": len(trust),
                "last_step": int(last["step"]),
                "per_leaf": {
                    name: {k: entry[k] for k in ("min", "mean", "max")}
                    for name, entry in last["layers"].items()
                },
                "hist": {"edges": edges, "counts": hist.tolist()},
            }

        stages = by_type.get("stage_start", [])
        if stages:
            report["stages"] = [
                {k: v for k, v in ev.items() if k not in ("event", "seq", "t")}
                for ev in stages
            ]
        ckpts = by_type.get("checkpoint", [])
        if ckpts:
            section: Dict[str, Any] = {
                "count": len(ckpts),
                "last_step": int(ckpts[-1]["step"]),
            }
            # async saves carry their phase timings: what the step loop paid
            # (snapshot + blocked) vs what overlapped with compute (write)
            asyncs = [ev for ev in ckpts if ev.get("mode") == "async"]
            if asyncs:
                def _mean(key):
                    return float(np.mean([float(ev[key]) for ev in asyncs]))

                section["async"] = {
                    "count": len(asyncs),
                    "snapshot_s_mean": _mean("snapshot_s"),
                    "blocked_s_mean": _mean("blocked_s"),
                    "blocked_s_max": float(
                        max(float(ev["blocked_s"]) for ev in asyncs)),
                    "write_s_mean": _mean("write_s"),
                    "write_s_total": float(
                        sum(float(ev["write_s"]) for ev in asyncs)),
                }
            report["checkpoints"] = section

        # fault tolerance: skip-step guard trips, supervisor rollbacks,
        # preemption saves — the counts the acceptance harness asserts on
        skips = by_type.get("nonfinite_step", [])
        rollbacks = by_type.get("rollback", [])
        preempts = by_type.get("preempt", [])
        if skips or rollbacks or preempts:
            ft: Dict[str, Any] = {
                "skipped_steps": int(sum(int(ev.get("count", 1))
                                         for ev in skips)),
                "rollbacks": len(rollbacks),
                "preempts": len(preempts),
            }
            if rollbacks:
                last = rollbacks[-1]
                ft["last_rollback"] = {
                    "step": int(last["step"]),
                    "from_step": int(last["from_step"]),
                    "reason": last["reason"],
                }
            if preempts:
                ft["last_preempt_step"] = int(preempts[-1]["step"])
            report["fault_tolerance"] = ft

        resumes = by_type.get("resume", [])
        if resumes:
            report["resume"] = {
                "count": len(resumes),
                "step": int(resumes[-1]["step"]),
            }

        sreqs = by_type.get("serve_request", [])
        sstats = by_type.get("serve_stats", [])
        if sreqs or sstats:
            serve: Dict[str, Any] = {
                "requests": len(sreqs),
                "dropped": sum(1 for ev in sreqs if ev.get("dropped")),
            }
            # disjoint terminal-state counts (each serve_request event is
            # one request's single terminal record, so these sum to
            # `requests`) plus the reliability lifecycle counters the serve
            # fault-injection gate asserts on
            statuses = [ev.get("status") for ev in sreqs]
            if any(s is not None for s in statuses):
                serve["by_status"] = {
                    s: statuses.count(s)
                    for s in ("completed", "shed", "timed_out", "failed")
                }
            lifecycle = {
                "sheds": len(by_type.get("serve_shed", [])),
                "timeouts": len(by_type.get("serve_timeout", [])),
                "retries": len(by_type.get("serve_retry", [])),
                "quarantines": len(by_type.get("serve_quarantine", [])),
                "degraded_transitions": len(by_type.get("serve_degraded", [])),
                "drains": len(by_type.get("serve_drain", [])),
            }
            if any(lifecycle.values()):
                serve["lifecycle"] = lifecycle
            if sstats:
                serve["stats"] = {
                    k: v for k, v in sstats[-1].items()
                    if k not in ("event", "seq", "t")
                }
            report["serve"] = serve

        bench: Dict[str, Any] = {}
        for ev in by_type.get("bench_result", []):
            bench[ev["name"]] = {
                k: v for k, v in ev.items() if k not in ("event", "seq", "t", "name")
            }
        if bench_dir is not None:
            for p in sorted(Path(bench_dir).glob("BENCH_*.json")):
                key = p.stem[len("BENCH_"):]
                try:
                    bench.setdefault(key, {})["json"] = json.loads(p.read_text())
                except (OSError, json.JSONDecodeError) as e:
                    bench.setdefault(key, {})["error"] = f"{type(e).__name__}: {e}"
        if bench:
            report["bench"] = bench
        return cls(report)

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, path: Union[str, Path]) -> "RunReport":
        return cls(json.loads(Path(path).read_text()))

    def write(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.report, indent=2, default=_jsonable))
        return p

    # ------------------------------------------------------------------
    def compare(
        self,
        baseline: Union["RunReport", Dict[str, Any]],
        tolerances: Dict[str, Optional[float]],
        *,
        require_sections: bool = True,
    ) -> CompareResult:
        """Regression-gate this report against ``baseline``.

        ``tolerances`` maps dotted key paths to a relative tolerance —
        ``None`` means *presence only* (the key must exist in this report;
        timing-ish values that legitimately drift), ``0.0`` means exact
        equality, ``r`` means ``|new - base| <= r * max(|base|, 1e-12)``.
        With ``require_sections`` every top-level section of the baseline
        must be present here (schema check).  A key missing from the
        *baseline* is checked for presence only — new reports may grow
        sections old baselines lack without failing the gate.
        """
        base = baseline.report if isinstance(baseline, RunReport) else baseline
        checks: List[Check] = []

        if require_sections:
            for section in base:
                status = "ok" if section in self.report else "missing"
                checks.append(Check(f"section:{section}", status))

        for key, tol in sorted(tolerances.items()):
            new = _get_path(self.report, key)
            ref = _get_path(base, key)
            if new is _MISSING:
                checks.append(Check(key, "missing", "absent from report"))
                continue
            if tol is None or ref is _MISSING:
                checks.append(Check(key, "ok", "present"))
                continue
            if isinstance(new, (int, float)) and isinstance(ref, (int, float)):
                diff = abs(float(new) - float(ref))
                bound = tol * max(abs(float(ref)), 1e-12)
                if diff <= bound:
                    checks.append(Check(
                        key, "ok", f"{new} vs {ref} (tol {tol})"))
                else:
                    checks.append(Check(
                        key, "regressed",
                        f"{new} vs baseline {ref} exceeds rel tol {tol}"))
            else:
                status = "ok" if new == ref else "mismatch"
                checks.append(Check(key, status, f"{new!r} vs {ref!r}"))

        return CompareResult(all(c.status == "ok" for c in checks), checks)
