"""Study: the hyperparameter-search CRD, the platform's katib analog.

Counterpart of `kubeflow_tpu/api/study.py` (a module with no JAX in
it), whole: a `Study` CR describes a parameter space, an objective and
a trial template; the controller (`controllers/study.py`) materializes
trials as `TpuJob`s and harvests each trial's `status.observation`,
which the launcher reports at job end. The four algorithms (random,
grid, bayesian TPE, successive halving) are pure Python on
`random.Random`, so for the same seed and history they suggest exactly
what the JAX package suggests.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any

KIND = "Study"

# Trial templates reference parameters as ${trialParameters.<name>} — the
# same substitution surface katib's trial templates use.
_PARAM_PREFIX = "${trialParameters."


@dataclasses.dataclass(frozen=True)
class ParameterSpec:
    """One search dimension."""

    name: str
    type: str = "double"  # double | int | categorical
    min: float | None = None
    max: float | None = None
    values: tuple[str, ...] = ()  # categorical
    log_scale: bool = False  # sample 10^U(log10 min, log10 max)
    grid_points: int = 3  # grid resolution for continuous dims

    def validate(self) -> None:
        if self.type in ("double", "int"):
            if self.min is None or self.max is None or self.min > self.max:
                raise ValueError(
                    f"parameter {self.name!r}: needs min <= max"
                )
            if self.log_scale and self.min <= 0:
                raise ValueError(
                    f"parameter {self.name!r}: log scale needs min > 0"
                )
        elif self.type == "categorical":
            if not self.values:
                raise ValueError(
                    f"parameter {self.name!r}: categorical needs values"
                )
        else:
            raise ValueError(
                f"parameter {self.name!r}: unknown type {self.type!r}"
            )

    def grid(self) -> list[Any]:
        self.validate()
        if self.type == "categorical":
            return list(self.values)
        if self.type == "int":
            lo, hi = int(self.min), int(self.max)
            n = min(self.grid_points, hi - lo + 1)
            if n <= 1:
                return [lo]
            return sorted({round(lo + i * (hi - lo) / (n - 1)) for i in range(n)})
        n = max(self.grid_points, 2)
        if self.log_scale:
            lo, hi = math.log10(self.min), math.log10(self.max)
            return [10 ** (lo + i * (hi - lo) / (n - 1)) for i in range(n)]
        return [self.min + i * (self.max - self.min) / (n - 1) for i in range(n)]

    def sample(self, rng: random.Random) -> Any:
        self.validate()
        if self.type == "categorical":
            return rng.choice(list(self.values))
        if self.type == "int":
            return rng.randint(int(self.min), int(self.max))
        if self.log_scale:
            return 10 ** rng.uniform(math.log10(self.min), math.log10(self.max))
        return rng.uniform(self.min, self.max)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"name": self.name, "type": self.type}
        if self.type == "categorical":
            d["values"] = list(self.values)
        else:
            d["min"] = self.min
            d["max"] = self.max
            if self.log_scale:
                d["logScale"] = True
            d["gridPoints"] = self.grid_points
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ParameterSpec":
        return cls(
            name=d["name"],
            type=d.get("type", "double"),
            min=d.get("min"),
            max=d.get("max"),
            values=tuple(d.get("values") or ()),
            log_scale=bool(d.get("logScale", False)),
            grid_points=int(d.get("gridPoints", 3)),
        )

    # -- TPE (bayesian) helpers ------------------------------------------

    def _to_z(self, v: float) -> float:
        return math.log10(v) if self.log_scale else float(v)

    def _from_z(self, z: float) -> Any:
        v = 10.0**z if self.log_scale else z
        if self.type == "int":
            return max(int(self.min), min(int(self.max), round(v)))
        return max(self.min, min(self.max, v))

    def usable(self, v: Any) -> bool:
        """Assignments are read back from client-writable annotations, so
        a malformed or out-of-range value must be dropped — never crash
        the suggester, never escape the declared search space."""
        if self.type == "categorical":
            return v in self.values
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return False
        if not math.isfinite(v) or not self.min <= v <= self.max:
            return False
        if self.type == "int" and v != int(v):
            return False
        return v > 0 if self.log_scale else True

    def tpe_sample(
        self,
        good: list[Any],
        bad: list[Any],
        rng: random.Random,
        n_candidates: int = 24,
    ) -> Any:
        """One Tree-structured-Parzen-Estimator draw for this dimension:
        sample candidates from the good-group density l(x), keep the one
        maximizing l(x)/g(x). A uniform prior component in both mixtures
        keeps exploration alive and the ratio finite."""
        good = [v for v in good if self.usable(v)]
        bad = [v for v in bad if self.usable(v)]
        if not good:
            return self.sample(rng)
        if self.type == "categorical":
            values = list(self.values)
            k = len(values)

            def probs(obs: list[Any]) -> dict[Any, float]:
                total = len(obs) + k
                return {
                    v: (1 + sum(1 for o in obs if o == v)) / total
                    for v in values
                }

            pg, pb = probs(good), probs(bad)
            candidates = rng.choices(
                values, weights=[pg[v] for v in values], k=n_candidates
            )
            return max(candidates, key=lambda v: pg[v] / pb[v])

        lo, hi = self._to_z(self.min), self._to_z(self.max)
        width = max(hi - lo, 1e-12)

        def mixture(obs: list[float]):
            sigma = max(width / (1 + math.sqrt(len(obs))), width * 0.01)

            def pdf(z: float) -> float:
                # Uniform prior counts as one extra mixture component.
                total = 1.0 / width
                for o in obs:
                    total += math.exp(-0.5 * ((z - o) / sigma) ** 2) / (
                        sigma * math.sqrt(2 * math.pi)
                    )
                return total / (len(obs) + 1)

            def draw() -> float:
                pick = rng.randrange(len(obs) + 1)
                if pick == len(obs):
                    return rng.uniform(lo, hi)
                return min(hi, max(lo, rng.gauss(obs[pick], sigma)))

            return pdf, draw

        zg = [self._to_z(v) for v in good]
        zb = [self._to_z(v) for v in bad]
        l_pdf, l_draw = mixture(zg)
        g_pdf, _ = mixture(zb)
        best_z = max(
            (l_draw() for _ in range(n_candidates)),
            key=lambda z: l_pdf(z) / g_pdf(z),
        )
        return self._from_z(best_z)


@dataclasses.dataclass(frozen=True)
class TrialRecord:
    """What the suggester knows about one materialized trial — rebuilt
    every reconcile from the trial jobs' labels/annotations/status, so
    suggestion state survives controller restarts for free."""

    index: int
    state: str  # Pending | Running | Succeeded | Failed | Pruned
    assignment: dict[str, Any] = dataclasses.field(default_factory=dict)
    objective: float | None = None

    @property
    def terminal(self) -> bool:
        return self.state in ("Succeeded", "Failed", "Pruned")

    @property
    def scored(self) -> bool:
        # A pruned trial scores with its last curve value: halving's
        # survivor ranking then naturally eliminates it (it was pruned
        # precisely for being worse than the median).
        return (
            self.state in ("Succeeded", "Pruned")
            and isinstance(self.objective, (int, float))
            and math.isfinite(self.objective)
        )


@dataclasses.dataclass(frozen=True)
class StudySpec:
    parameters: tuple[ParameterSpec, ...]
    objective_metric: str = "loss"
    goal: str = "minimize"  # minimize | maximize
    # random | grid | bayesian (TPE) | halving (successive halving) — the
    # algorithm surface the reference consumed from katib
    # (testing/katib_studyjob_test.py exercises StudyJobs whose suggestion
    # services included random/grid/bayesian/hyperband).
    algorithm: str = "random"
    seed: int = 0
    max_trials: int = 10
    parallelism: int = 2
    max_failed_trials: int = 3
    # bayesian: trials sampled at random before TPE engages, and the
    # quantile of history treated as the "good" group.
    startup_trials: int = 5
    gamma: float = 0.25
    # halving: rung r runs max(1, max_trials // eta^r) configs; the TOP
    # rung runs at exactly max_budget and earlier rungs at
    # max_budget/eta^k (min_budget sets how many rungs fit — see
    # rungs()). The budget value is exposed to the trial template as
    # ${trialParameters.<budget_parameter>}.
    eta: int = 3
    min_budget: float = 1.0
    max_budget: float = 9.0
    budget_parameter: str = "budget"
    # Early stopping on trial metric curves (`status.metrics`, reported
    # via launcher.report_metrics): a running trial whose curve value at
    # step s is worse than the median of its peers' values at s is pruned
    # mid-run (katib's median-stopping rule). Off unless minSteps is set.
    #   {"minSteps": int   — don't judge before this step,
    #    "minPeers": int}  — need this many comparable peers (default 2)
    early_stopping: dict[str, Any] = dataclasses.field(default_factory=dict)
    # TpuJob spec dict with ${trialParameters.<name>} placeholders.
    trial_template: dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        if not self.parameters:
            raise ValueError("study needs at least one parameter")
        seen = set()
        for p in self.parameters:
            if p.name in seen:
                raise ValueError(f"duplicate parameter {p.name!r}")
            seen.add(p.name)
            p.validate()
        if self.goal not in ("minimize", "maximize"):
            raise ValueError(f"goal must be minimize|maximize, got {self.goal!r}")
        if self.algorithm not in ("random", "grid", "bayesian", "halving"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.max_trials < 1 or self.parallelism < 1:
            raise ValueError("max_trials and parallelism must be >= 1")
        if self.algorithm == "bayesian":
            if not 0 < self.gamma < 1:
                raise ValueError("gamma must be in (0, 1)")
            if self.startup_trials < 1:
                raise ValueError("startupTrials must be >= 1")
        if self.early_stopping:
            if int(self.early_stopping.get("minSteps", 0)) < 1:
                raise ValueError(
                    "earlyStopping.minSteps must be >= 1 (it is the "
                    "enable switch)"
                )
            if int(self.early_stopping.get("minPeers", 2)) < 1:
                raise ValueError("earlyStopping.minPeers must be >= 1")
        if self.algorithm == "halving":
            if self.eta < 2:
                raise ValueError("eta must be >= 2")
            if not 0 < self.min_budget <= self.max_budget:
                raise ValueError("need 0 < minBudget <= maxBudget")
            if self.budget_parameter in seen:
                raise ValueError(
                    f"budgetParameter {self.budget_parameter!r} collides "
                    "with a search parameter"
                )

    # -- suggestion ------------------------------------------------------

    def grid_size(self) -> int:
        size = 1
        for p in self.parameters:
            size *= len(p.grid())
        return size

    def grid_assignments(self) -> list[dict[str, Any]]:
        """Cartesian product in parameter order (deterministic)."""
        return [self._grid_assignment(i) for i in range(self.grid_size())]

    def _grid_assignment(self, index: int) -> dict[str, Any]:
        """Index the Cartesian product directly (mixed-radix, last
        parameter fastest) — O(#params) per call, no enumeration, so a
        reconcile over a 10^5-point grid stays cheap."""
        assignment = {}
        for p in reversed(self.parameters):
            values = p.grid()
            index, digit = divmod(index, len(values))
            assignment[p.name] = values[digit]
        return {p.name: assignment[p.name] for p in self.parameters}

    def assignment_for(self, trial_index: int) -> dict[str, Any] | None:
        """The parameter assignment for trial N, or None when the space is
        exhausted. Deterministic in (spec, trial_index) so a restarted
        controller regenerates identical trials (crash-safe suggestion
        without persisted sampler state)."""
        self.validate()
        if self.algorithm == "grid":
            if trial_index >= self.grid_size():
                return None
            return self._grid_assignment(trial_index)
        rng = random.Random(f"{self.seed}:{trial_index}")
        return {p.name: p.sample(rng) for p in self.parameters}

    def total_trials(self) -> int:
        if self.algorithm == "grid":
            return min(self.max_trials, self.grid_size())
        if self.algorithm == "halving":
            return sum(width for _, width, _ in self.rungs())
        return self.max_trials

    # -- history-aware suggestion ----------------------------------------

    def suggest(
        self,
        records: list[TrialRecord],
        slots: int,
        floor: int = -1,
    ) -> tuple[list[tuple[int, dict[str, Any]]], bool]:
        """Propose up to `slots` new trials given the observed history.

        Returns `(new, done)`: `new` is a list of (trial index, assignment)
        to materialize now; `done` means no trial beyond those will ever be
        suggested, so the study is terminal once nothing is active. State
        is re-derived from `records` plus `floor` — the highest trial
        index ever created (the controller persists it in study status) —
        so indices whose trials were deleted stay spent even when nothing
        above them survives to witness the deletion positionally.
        """
        self.validate()
        if self.algorithm == "halving":
            return self._suggest_halving(records, slots, floor)
        return self._suggest_sequential(records, slots, floor)

    def _suggest_sequential(
        self, records: list[TrialRecord], slots: int, floor: int = -1
    ) -> tuple[list[tuple[int, dict[str, Any]]], bool]:
        """random / grid / bayesian: one flat sequence of trial indices.

        Indices are never re-suggested (a deleted trial stays spent), so
        `next` continues past the highest index ever created.
        """
        created = {r.index for r in records}
        count = len(created)
        nxt = max(max(created, default=-1), floor) + 1
        total = self.total_trials()
        new: list[tuple[int, dict[str, Any]]] = []
        exhausted = False
        while count + len(new) < total and len(new) < slots:
            if self.algorithm == "grid" and nxt >= self.grid_size():
                exhausted = True
                break
            new.append((nxt, self._sequential_assignment(nxt, records)))
            nxt += 1
        done = exhausted or count + len(new) >= total
        return new, done

    def _sequential_assignment(
        self, index: int, records: list[TrialRecord]
    ) -> dict[str, Any]:
        if self.algorithm == "bayesian":
            completed = [r for r in records if r.scored]
            if len(completed) >= self.startup_trials:
                rng = random.Random(f"{self.seed}:{index}")
                return self._tpe_assignment(completed, rng)
        return self.assignment_for(index)

    def _ranked(self, records: list[TrialRecord]) -> list[TrialRecord]:
        """Scored records, best objective first (index breaks ties)."""
        sign = 1.0 if self.goal == "minimize" else -1.0
        return sorted(
            (r for r in records if r.scored),
            key=lambda r: (sign * r.objective, r.index),
        )

    def _tpe_assignment(
        self, completed: list[TrialRecord], rng: random.Random
    ) -> dict[str, Any]:
        ranked = self._ranked(completed)
        n_good = max(1, round(self.gamma * len(ranked)))
        good, bad = ranked[:n_good], ranked[n_good:]
        out: dict[str, Any] = {}
        for p in self.parameters:
            gv = [r.assignment[p.name] for r in good if p.name in r.assignment]
            bv = [r.assignment[p.name] for r in bad if p.name in r.assignment]
            out[p.name] = p.tpe_sample(gv, bv, rng)
        return out

    # -- successive halving ----------------------------------------------

    def rungs(self) -> list[tuple[int, int, float | int]]:
        """(first trial index, width, budget) per rung. Standard
        successive halving: the TOP rung runs exactly at max_budget and
        earlier rungs at max_budget/eta^k (so every bracket ends with the
        winner evaluated at the full requested budget); min_budget sets
        how many rungs fit. Widths shrink by eta; integral budgets stay
        ints so `${trialParameters.budget}` substitutes cleanly into step
        counts."""
        n_rungs = 1 + int(
            math.floor(
                math.log(self.max_budget / self.min_budget)
                / math.log(self.eta)
                + 1e-9
            )
        )
        out = []
        start = 0
        for r in range(n_rungs):
            width = max(1, self.max_trials // self.eta**r)
            budget = self.max_budget / self.eta ** (n_rungs - 1 - r)
            if float(budget).is_integer():
                budget = int(budget)
            out.append((start, width, budget))
            start += width
        return out

    def _suggest_halving(
        self, records: list[TrialRecord], slots: int, floor: int = -1
    ) -> tuple[list[tuple[int, dict[str, Any]]], bool]:
        by_index = {r.index: r for r in records}
        new: list[tuple[int, dict[str, Any]]] = []
        rungs = self.rungs()
        # Each rung's *actual* extent can be narrower than planned (fewer
        # survivors than width), so the chain of (start, target) pairs is
        # recomputed from the records every reconcile — settlement checks
        # must use the actual extent, never the planned width.
        prev_start = prev_target = 0
        for ri, (start, width, budget) in enumerate(rungs):
            if ri == 0:
                configs: list[dict[str, Any]] | None = None  # lazy random
                target = width
            else:
                if not self._rung_settled(
                    by_index, prev_start, prev_target, floor
                ):
                    return new, False  # previous rung still running
                prev = [
                    by_index[i]
                    for i in range(prev_start, prev_start + prev_target)
                    if i in by_index
                ]
                # Only records whose stored assignment round-trips cleanly
                # can be promoted — a wiped/corrupted annotation must not
                # become an unrenderable trial spec.
                ranked = [
                    r for r in self._ranked(prev)
                    if self._assignment_usable(r.assignment)
                ][:width]
                if not ranked:
                    # Nothing survived the previous rung — the bracket is
                    # over (the failure budget catches pathological cases).
                    return new, True
                configs = [
                    {
                        k: v
                        for k, v in r.assignment.items()
                        if k != self.budget_parameter
                    }
                    for r in ranked
                ]
                target = len(configs)
            # An absent index at or below the high-water mark (or, as a
            # fallback when the mark is stale, below the rung's highest
            # present index — trials are created in ascending order) was
            # deleted after creation and stays spent: a deleted trial is
            # never re-run, it just can't be promoted.
            max_present = self._max_present(by_index, start, target)
            for j in range(target):
                idx = start + j
                if idx in by_index or idx < max_present or idx <= floor:
                    continue
                if len(new) >= slots:
                    return new, False
                if configs is None:
                    a = self.assignment_for(idx)
                else:
                    a = dict(configs[j])
                a[self.budget_parameter] = budget
                new.append((idx, a))
            if new or not self._rung_settled(by_index, start, target, floor):
                return new, False
            prev_start, prev_target = start, target
        return new, True

    def _assignment_usable(self, assignment: dict[str, Any]) -> bool:
        return all(
            p.name in assignment and p.usable(assignment[p.name])
            for p in self.parameters
        )

    @staticmethod
    def _max_present(
        by_index: dict[int, TrialRecord], start: int, target: int
    ) -> int:
        return max(
            (i for i in range(start, start + target) if i in by_index),
            default=start - 1,
        )

    def _rung_settled(
        self,
        by_index: dict[int, TrialRecord],
        start: int,
        target: int,
        floor: int = -1,
    ) -> bool:
        """A rung is settled when every index was created and is terminal,
        counting created-then-deleted indices (at/below the high-water
        mark, or below the rung's highest present index) as spent."""
        max_present = self._max_present(by_index, start, target)
        for i in range(start, start + target):
            record = by_index.get(i)
            if record is None:
                if i > max_present and i > floor:
                    return False  # never created yet
                continue  # deleted: spent
            if not record.terminal:
                return False
        return True

    def to_dict(self) -> dict[str, Any]:
        algorithm: dict[str, Any] = {"name": self.algorithm, "seed": self.seed}
        if self.algorithm == "bayesian":
            algorithm["startupTrials"] = self.startup_trials
            algorithm["gamma"] = self.gamma
        if self.algorithm == "halving":
            algorithm["eta"] = self.eta
            algorithm["minBudget"] = self.min_budget
            algorithm["maxBudget"] = self.max_budget
            algorithm["budgetParameter"] = self.budget_parameter
        d = {
            "parameters": [p.to_dict() for p in self.parameters],
            "objective": {"metric": self.objective_metric, "goal": self.goal},
            "algorithm": algorithm,
            "maxTrials": self.max_trials,
            "parallelism": self.parallelism,
            "maxFailedTrials": self.max_failed_trials,
            "trialTemplate": dict(self.trial_template),
        }
        if self.early_stopping:
            d["earlyStopping"] = dict(self.early_stopping)
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "StudySpec":
        objective = d.get("objective") or {}
        algorithm = d.get("algorithm") or {}
        spec = cls(
            parameters=tuple(
                ParameterSpec.from_dict(p) for p in d.get("parameters") or ()
            ),
            objective_metric=objective.get("metric", "loss"),
            goal=objective.get("goal", "minimize"),
            algorithm=algorithm.get("name", "random"),
            seed=int(algorithm.get("seed", 0)),
            startup_trials=int(algorithm.get("startupTrials", 5)),
            gamma=float(algorithm.get("gamma", 0.25)),
            eta=int(algorithm.get("eta", 3)),
            min_budget=float(algorithm.get("minBudget", 1.0)),
            max_budget=float(algorithm.get("maxBudget", 9.0)),
            budget_parameter=algorithm.get("budgetParameter", "budget"),
            max_trials=int(d.get("maxTrials", 10)),
            parallelism=int(d.get("parallelism", 2)),
            max_failed_trials=int(d.get("maxFailedTrials", 3)),
            early_stopping=dict(d.get("earlyStopping") or {}),
            trial_template=dict(d.get("trialTemplate") or {}),
        )
        spec.validate()
        return spec

    # -- early stopping (median rule over metric curves) -----------------

    @property
    def prunes(self) -> bool:
        return bool(self.early_stopping.get("minSteps"))

    def should_prune(
        self,
        curve: list[tuple[int, float]],
        peer_curves: list[list[tuple[int, float]]],
    ) -> bool:
        """Curve-based early stopping, conservative by construction:
        prune only a trial whose objective at its latest step is strictly
        worse than EVERY peer's value at that step (which implies worse
        than the peer median — katib's median-stop criterion — but cannot
        cascade: naive worse-than-median pruning re-shifts the median
        after each prune and eliminates half the healthy trials, while
        worse-than-all prunes exactly the stragglers; bulk elimination
        stays where it belongs, at halving's rung boundaries). Pruned
        trials' last values remain in the comparison set, anchoring it.

        Curves are (step, value) ascending; a peer contributes its value
        at the largest step <= s, so a peer ahead of this trial is judged
        where this trial is, not where the peer is."""
        if not self.prunes or not curve:
            return False
        min_steps = int(self.early_stopping.get("minSteps", 0))
        min_peers = int(self.early_stopping.get("minPeers", 2))
        step, value = curve[-1]
        if step < min_steps or not math.isfinite(value):
            return False
        peer_values = []
        for peer in peer_curves:
            at = [v for s, v in peer if s <= step]
            if at and math.isfinite(at[-1]):
                peer_values.append(at[-1])
        if len(peer_values) < min_peers:
            return False
        if self.goal == "minimize":
            return value > max(peer_values)
        return value < min(peer_values)


def render_template(template: Any, assignment: dict[str, Any]) -> Any:
    """Substitute ${trialParameters.<name>} through a nested spec dict.

    A string that is exactly one placeholder keeps the parameter's native
    type; placeholders embedded in longer strings are formatted in (floats
    with repr so values round-trip)."""

    def fmt(v: Any) -> str:
        return repr(v) if isinstance(v, float) else str(v)

    def subst(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: subst(v) for k, v in node.items()}
        if isinstance(node, list):
            return [subst(v) for v in node]
        if isinstance(node, str):
            for name, value in assignment.items():
                placeholder = f"{_PARAM_PREFIX}{name}}}"
                if node == placeholder:
                    return value
                if placeholder in node:
                    node = node.replace(placeholder, fmt(value))
            if _PARAM_PREFIX in node:
                raise ValueError(f"unresolved trial parameter in {node!r}")
            return node
        return node

    return subst(template)
