"""Analytical models for DeltaGraph space and retrieval time (paper §5).

Graph-dynamics model (§5.1): a fraction ``delta_star`` of events are
inserts, ``rho_star`` are deletes (an update = delete+insert), so
``|G_{|E|}| = |G_0| + |E|·(delta_star − rho_star)``.  Event density over
time is ``g(t)`` (super-linear for most real networks).

Implemented closed forms (§5.3):

* Balanced function — per-level delta sizes, total index space, and the
  (uniform) root→leaf path weight.
* Intersection function — root size for ``rho*=0``, ``delta*=rho*`` and
  ``delta*=2 rho*``; path weight = leaf size.
* Copy+Log (= Empty differential function) — stored-snapshot space.

plus :func:`estimate_rates` (fit δ*, ρ* from an eventlist) and
:func:`choose_parameters`, the §5.4 guidance: pick (k, L, f) for a space
budget / latency target.  Everything here is validated against measured
index sizes in ``tests/test_analysis.py``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .events import (EV_DEL_EDGE, EV_DEL_NODE, EV_NEW_EDGE, EV_NEW_NODE,
                     EventList)


@dataclasses.dataclass
class Rates:
    delta_star: float   # insert fraction
    rho_star: float     # delete fraction
    g0: float           # |G_0|
    n_events: int

    @property
    def final_size(self) -> float:
        return self.g0 + self.n_events * (self.delta_star - self.rho_star)


def estimate_rates(events: EventList, g0: int = 0) -> Rates:
    et = events.etype
    ins = int(np.isin(et, (EV_NEW_NODE, EV_NEW_EDGE)).sum())
    dels = int(np.isin(et, (EV_DEL_NODE, EV_DEL_EDGE)).sum())
    n = len(events)
    return Rates(ins / max(n, 1), dels / max(n, 1), g0, n)


# ---------------------------------------------------------------------------
# Balanced differential function (§5.3)
# ---------------------------------------------------------------------------

def balanced_delta_size(level: int, L: int, k: int, rates: Rates) -> float:
    """|Δ(p, c_i)| (events) for an interior node p at ``level`` (leaves are
    level 1): ``½ (k−1) k^{level−2} (δ*+ρ*) L``."""
    if level < 2:
        raise ValueError("interior levels start at 2")
    s = rates.delta_star + rates.rho_star
    return 0.5 * (k - 1) * (k ** (level - 2)) * s * L


def balanced_level_space(L: int, k: int, rates: Rates) -> float:
    """Total delta events at any single interior level — the §5.3 surprise:
    it is the same at every level, ``½ (k−1)(δ*+ρ*)|E|``.

    (Exact form: with ``N = ⌊|E|/L⌋ + 1`` leaves there are N level-2 edges,
    giving ``½(k−1)(δ*+ρ*)(|E|+L)`` — the paper drops the ``+L`` as
    asymptotically negligible; we keep it so tests can assert tightly.)
    """
    return 0.5 * (k - 1) * (rates.delta_star + rates.rho_star) * (
        rates.n_events + L)


def balanced_total_space(L: int, k: int, rates: Rates) -> float:
    """All delta events excluding the super-root edge.

    The paper quotes ``(log_k N − 1)/2 (k−1)(δ*+ρ*)|E|``, counting the root
    level into the super-root edge; measured against our index (which hangs
    the root off the super-root separately) the exact count is
    ``log_k N`` interior levels × the constant per-level space.
    """
    N = rates.n_events / L + 1
    levels = math.log(max(N, 1.0), k)
    return levels * balanced_level_space(L, k, rates)


def balanced_root_size(rates: Rates) -> float:
    """|root| = |G_0| + ½ (δ*−ρ*) |E| (independent of k)."""
    return rates.g0 + 0.5 * (rates.delta_star - rates.rho_star) * rates.n_events


def balanced_path_weight(rates: Rates) -> float:
    """Super-root → any leaf total weight: |root| + ½(δ*+ρ*)|E|.

    The paper quotes the root→leaf part, ``½(δ*+ρ*)|E|``; retrieval from
    cold (no materialization) adds the root itself.
    """
    return balanced_root_size(rates) + 0.5 * (
        rates.delta_star + rates.rho_star) * rates.n_events


# ---------------------------------------------------------------------------
# Intersection differential function (§5.3)
# ---------------------------------------------------------------------------

def intersection_root_size(rates: Rates) -> float:
    """Root size under Intersection for the three §5.3 special cases (and a
    smooth interpolation elsewhere, labelled as such)."""
    g0, E = rates.g0, rates.n_events
    d, r = rates.delta_star, rates.rho_star
    if r == 0:
        return g0
    if abs(d - r) < 1e-12:
        return g0 * math.exp(-E * d / max(g0, 1e-9))
    if abs(d - 2 * r) < 1e-12:
        return g0 * g0 / (g0 + r * E)
    # interpolation between the δ*=ρ* and δ*=2ρ* regimes (not in paper)
    w = min(max((d / max(r, 1e-12) - 1.0), 0.0), 1.0)
    return ((1 - w) * g0 * math.exp(-E * d / max(g0, 1e-9))
            + w * g0 * g0 / (g0 + r * E))


def intersection_path_weight(leaf_size: float) -> float:
    """Under Intersection the super-root→leaf weight is exactly the leaf
    size (each interior node ⊆ each child)."""
    return leaf_size


# ---------------------------------------------------------------------------
# Copy+Log & comparisons (§5.4)
# ---------------------------------------------------------------------------

def copylog_space(L: int, rates: Rates) -> float:
    """Stored snapshots every L events + the log itself (events)."""
    N = int(rates.n_events / L) + 1
    sizes = [rates.g0 + i * L * (rates.delta_star - rates.rho_star)
             for i in range(N)]
    return float(sum(sizes) + rates.n_events)


def interval_tree_space(rates: Rates) -> float:
    """O(|E|): each element contributes one interval."""
    return float(rates.n_events)


def segment_tree_space(rates: Rates) -> float:
    """O(|E| log |E|) — duplicated interval storage."""
    E = max(rates.n_events, 2)
    return float(E * math.log2(E))


def expected_singlepoint_bytes(rates: Rates, L: int, k: int,
                               diff_fn: str = "balanced") -> float:
    """Expected cold singlepoint retrieval weight in events (≈ bytes up to
    the per-event encoding constant): super-root→leaf path weight plus half
    a leaf-eventlist.  The materialization advisor uses this as its
    cold-start prior before any query has been recorded."""
    if diff_fn == "intersection":
        return rates.final_size + L / 2
    return balanced_path_weight(rates) + L / 2


# ---------------------------------------------------------------------------
# §5.4 parameter guidance
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParameterChoice:
    L: int
    k: int
    diff_fn: str
    expected_space_events: float
    expected_path_events: float
    rationale: str


def choose_parameters(rates: Rates, *, space_budget_events: float | None = None,
                      latency_budget_events: float | None = None,
                      prefer_uniform_latency: bool = True,
                      recent_biased: bool = False) -> ParameterChoice:
    """Pick (L, k, f) per §5.4: Intersection when space is paramount,
    Mixed/Balanced otherwise; higher arity lowers latency but costs space;
    larger L shrinks the index but slows queries."""
    best = None
    fns = ["balanced", "intersection"] if prefer_uniform_latency else [
        "intersection", "balanced"]
    if recent_biased:
        fns = ["mixed"] + fns
    for k in (2, 3, 4, 8, 16):
        for L_frac in (0.002, 0.005, 0.01, 0.02, 0.05):
            L = max(int(rates.n_events * L_frac), 16)
            for fn in fns:
                if fn == "intersection":
                    space = rates.n_events * (rates.delta_star + rates.rho_star)
                    path = rates.final_size + L / 2
                else:
                    space = balanced_total_space(L, k, rates)
                    path = balanced_path_weight(rates) + L / 2
                if space_budget_events is not None and space > space_budget_events:
                    continue
                if latency_budget_events is not None and path > latency_budget_events:
                    continue
                score = path + 0.1 * space / max(rates.n_events, 1)
                if best is None or score < best[0]:
                    best = (score, ParameterChoice(
                        L, k, fn, space, path,
                        f"min path+0.1·space among feasible; f={fn}"))
    if best is None:
        raise ValueError("no (L, k, f) satisfies the given budgets")
    return best[1]
