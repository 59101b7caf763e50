"""Per-layer trust-ratio recorder (host side of the App. H diagnostics;
port of ``repro.telemetry.trust``).

The device side lives in the train step: with
``TrainConfig.record_trust_ratios`` the step returns, under
``metrics["telemetry/per_layer"]``, three trees keyed like the params —
``trust_ratio`` (the ratio the optimizer actually applied: K2's aux output
on the fused path, recomputed as ``phi(||x||)/||Δx||`` on a transform
chain), ``param_norm`` and ``update_norm``, each a per-layer-slice vector
on stacked leaves.  They stay on the device until the Trainer's log step
fetches them in one transfer.

This module is what happens after the fetch: :class:`TrustRecorder` names
every leaf, histograms the ratios on fixed log-spaced bins (the paper's
Figures 9–14 span ~1e-3…30, so ratios are compared on a log axis), emits a
``trust_ratios`` event per logged step, and keeps running per-leaf
aggregates for the run report.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.telemetry.events import EventLog

# Reserved metrics key the train step parks the per-layer pytrees under and
# the Trainer pops before building its scalar history.
PER_LAYER_KEY = "telemetry/per_layer"

# log10-spaced histogram edges covering the trust-ratio range the paper
# plots (App. H): 1e-4 … 1e2.
HIST_EDGES = np.logspace(-4.0, 2.0, 25)


def leaf_names(tree: Any) -> List[str]:
    """Stable dotted names for a tree's leaves (param paths), the JAX
    package's names for the same leaves: ``blocks.attn.wq``."""
    from repro_torch.checkpoint.io import tree_leaves_with_paths

    return [path.replace("/", ".") or "param"
            for path, _ in tree_leaves_with_paths(tree)]


def named_leaves(tree: Any) -> List[Tuple[str, np.ndarray]]:
    from repro_torch.checkpoint.io import tree_leaves_with_paths

    leaves = [np.atleast_1d(np.asarray(x)) for _, x in tree_leaves_with_paths(tree)]
    return list(zip(leaf_names(tree), leaves))


class TrustRecorder:
    """Folds per-layer records into histograms + per-leaf running stats.

    ``record`` consumes one logged step's host-side records (the popped
    ``telemetry/per_layer`` pytrees) and is cheap: vectors are n_layers
    long, not parameter-sized.
    """

    def __init__(self, log: Optional[EventLog] = None,
                 edges: np.ndarray = HIST_EDGES):
        self.log = log
        self.edges = np.asarray(edges, np.float64)
        self._hist = np.zeros(len(self.edges) - 1, np.int64)
        self._per_leaf: Dict[str, Dict[str, float]] = {}
        self.steps_recorded = 0

    def record(self, step: int, records: Dict[str, Any]) -> Dict[str, Any]:
        """Ingest one step's records; returns the emitted per-leaf layers dict."""
        ratios = named_leaves(records["trust_ratio"])
        pnorms = dict(named_leaves(records.get("param_norm", {})))
        unorms = dict(named_leaves(records.get("update_norm", {})))

        layers: Dict[str, Dict[str, Any]] = {}
        all_r = []
        for name, r in ratios:
            r = np.asarray(r, np.float64).reshape(-1)
            all_r.append(r)
            entry = {
                "min": float(r.min()),
                "mean": float(r.mean()),
                "max": float(r.max()),
                "per_layer": [float(x) for x in r],
            }
            if name in pnorms:
                entry["param_norm"] = [float(x) for x in
                                       np.asarray(pnorms[name]).reshape(-1)]
            if name in unorms:
                entry["update_norm"] = [float(x) for x in
                                        np.asarray(unorms[name]).reshape(-1)]
            layers[name] = entry
            agg = self._per_leaf.setdefault(
                name, {"min": np.inf, "max": -np.inf, "sum": 0.0, "n": 0})
            agg["min"] = min(agg["min"], entry["min"])
            agg["max"] = max(agg["max"], entry["max"])
            agg["sum"] += float(r.sum())
            agg["n"] += r.size

        flat = np.concatenate(all_r) if all_r else np.zeros(0)
        counts, _ = np.histogram(flat, bins=self.edges)
        self._hist += counts
        self.steps_recorded += 1
        if self.log is not None:
            self.log.emit(
                "trust_ratios", step=int(step), layers=layers,
                hist={"edges": self.edges.tolist(),
                      "counts": counts.tolist()},
            )
        return layers

    def summary(self) -> Dict[str, Any]:
        """Run-level aggregate for the report (empty dict when never fed)."""
        if not self.steps_recorded:
            return {}
        return {
            "steps_recorded": self.steps_recorded,
            "hist": {"edges": self.edges.tolist(),
                     "counts": self._hist.tolist()},
            "per_leaf": {
                name: {"min": agg["min"], "max": agg["max"],
                       "mean": agg["sum"] / max(agg["n"], 1)}
                for name, agg in self._per_leaf.items()
            },
        }
