"""Workflow: DAG-of-steps CRD — the platform's Argo-workflow analog.

The reference's CI and its ml-pipeline component both run on Argo: jsonnet
DAGs of container steps sharing an NFS volume, with an exit handler that
tears down no matter what (`testing/workflows/components/
kfctl_go_test.jsonnet:88-165,384-391`, `workflows.libsonnet:348-397`).
This CRD captures that shape natively: steps with dependencies, per-step
retries, a shared artifacts volume, and an `onExit` step that always runs
once the DAG is terminal.

Counterpart of `kubeflow_tpu/api/workflow.py` (a module with no JAX in
it), whole, with the same templating rules: `eval_when` parses its
operator from the raw expression before it renders the operands,
`render_value` substitutes in one pass and never rescans its output, and
a slice step's `tpuJob` spec is rendered string by string, so a typed
value (``replicas``, ``tpu.chipsPerWorker``) reaches the TpuJob
admission in its own type. A slice step runs on the port's TpuJob
operator, whose workers ask for GPUs (`api/tpujob.py`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping

KIND = "Workflow"


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """One DAG node: a container run to completion.

    `with_items` fans the step out into one instance per item at spec
    load time (`<name>-<i>`, with `${item}` substituted in command/args/
    env) — the Argo `withItems` surface. `when` is a conditional guard
    evaluated after templating, once dependencies are satisfied: false →
    the step is Skipped, and (Argo DAG semantics) dependents still run.

    `tpu_job` makes the step a SLICE step: instead of one pod, the
    controller materializes a TpuJob (a whole gang on TPU hardware) and
    maps its phase onto the step; the job's reported observation becomes
    the step's output. This is how a CI DAG gates on real training — the
    reference ran its training smoke tests as Argo steps shelling out to
    kubectl (`kfctl_go_test.jsonnet`); here the operator is native."""

    name: str
    command: tuple[str, ...] = ()
    args: tuple[str, ...] = ()
    image: str = "kubeflow-tpu/ci-runner:latest"
    env: tuple[tuple[str, str], ...] = ()
    dependencies: tuple[str, ...] = ()
    retries: int = 0
    with_items: tuple[str, ...] = ()
    when: str = ""
    # TpuJobSpec dict — mutually exclusive with command.
    tpu_job: dict[str, Any] | None = None

    def validate(self) -> None:
        if not self.name:
            raise ValueError("step needs a name")
        if self.tpu_job is not None:
            # The job spec carries its own command/args/env/image; pod-
            # level fields on a slice step would be silently ignored —
            # reject them instead.
            ignored = [
                field
                for field, is_set in (
                    ("command", bool(self.command)),
                    ("args", bool(self.args)),
                    ("env", bool(self.env)),
                    ("image",
                     self.image != "kubeflow-tpu/ci-runner:latest"),
                )
                if is_set
            ]
            if ignored:
                raise ValueError(
                    f"step {self.name!r}: tpuJob and "
                    f"{'/'.join(ignored)} are mutually exclusive (set "
                    "them inside the tpuJob spec)"
                )
            # Admission-time job validation — a typo'd TpuJob must not
            # burn the step's whole retry budget on identical runtime
            # InvalidSpec failures. Skipped when the spec contains
            # template tokens (final values unknown until render).
            if not any(
                "${" in s for s in _iter_strings(self.tpu_job)
            ):
                from kubeflow_tpu_torch.api.tpujob import TpuJobSpec

                try:
                    TpuJobSpec.from_dict(self.tpu_job)
                except Exception as e:
                    raise ValueError(
                        f"step {self.name!r}: invalid tpuJob: {e}"
                    ) from e
        elif not self.command:
            raise ValueError(f"step {self.name!r} needs a command or tpuJob")
        if self.retries < 0:
            raise ValueError(f"step {self.name!r}: retries must be >= 0")

    def to_dict(self) -> dict[str, Any]:
        d = {
            "name": self.name,
            "command": list(self.command),
            "args": list(self.args),
            "image": self.image,
            "env": [{"name": k, "value": v} for k, v in self.env],
            "dependencies": list(self.dependencies),
            "retries": self.retries,
        }
        if self.with_items:
            d["withItems"] = list(self.with_items)
        if self.when:
            d["when"] = self.when
        if self.tpu_job is not None:
            d["tpuJob"] = dict(self.tpu_job)
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "StepSpec":
        return cls(
            name=d.get("name", ""),
            command=tuple(d.get("command") or ()),
            args=tuple(d.get("args") or ()),
            image=d.get("image", "kubeflow-tpu/ci-runner:latest"),
            env=tuple(
                (e["name"], e["value"]) for e in d.get("env") or ()
            ),
            dependencies=tuple(d.get("dependencies") or ()),
            retries=int(d.get("retries", 0)),
            with_items=tuple(str(i) for i in d.get("withItems") or ()),
            when=str(d.get("when", "")),
            tpu_job=(
                dict(d["tpuJob"]) if d.get("tpuJob") is not None else None
            ),
        )


@dataclasses.dataclass(frozen=True)
class WorkflowSpec:
    steps: tuple[StepSpec, ...]
    # Runs exactly once when the DAG reaches a terminal state, success or
    # failure — the Argo exit-handler (teardown) contract.
    on_exit: StepSpec | None = None
    # Host path every step sees at STEP_ARTIFACTS (the NFS share analog).
    artifacts_dir: str = ""
    parallelism: int = 8
    # Workflow-level parameters, substituted into step command/args/env as
    # ${workflow.parameters.<name>} — the Argo templating surface the
    # reference's jsonnet workflows parameterize with
    # (workflows.libsonnet's per-workflow params).
    parameters: dict[str, str] = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        if not self.steps:
            raise ValueError("workflow needs at least one step")
        names = set()
        for s in self.steps:
            s.validate()
            if s.name in names:
                raise ValueError(f"duplicate step {s.name!r}")
            names.add(s.name)
        if self.on_exit is not None:
            self.on_exit.validate()
            if self.on_exit.name in names:
                raise ValueError("onExit step name collides with a DAG step")
            if self.on_exit.dependencies:
                raise ValueError("onExit step cannot have dependencies")
            if self.on_exit.with_items:
                raise ValueError("onExit step cannot fan out (withItems)")
            if self.on_exit.when:
                raise ValueError(
                    "onExit step cannot be conditional — teardown must "
                    "never be skipped"
                )
        for s in self.steps:
            for dep in s.dependencies:
                if dep not in names:
                    raise ValueError(
                        f"step {s.name!r} depends on unknown step {dep!r}"
                    )
        self._check_acyclic()
        self._check_output_refs()
        if self.parallelism < 1:
            raise ValueError("parallelism must be >= 1")

    def _check_output_refs(self) -> None:
        """`${steps.X.output}` is only well-defined when X is a
        (transitive) dependency — otherwise rendering would succeed or
        fail depending on step timing. Argo infers dependencies from
        such references; here they must be declared, and this check makes
        the omission a load-time error instead of a nondeterministic
        runtime failure."""
        deps = {s.name: set(s.dependencies) for s in self.steps}

        def closure(name: str) -> set[str]:
            seen: set[str] = set()
            stack = list(deps.get(name, ()))
            while stack:
                d = stack.pop()
                if d not in seen:
                    seen.add(d)
                    stack.extend(deps.get(d, ()))
            return seen

        for s in self.steps:
            reachable = closure(s.name)
            for value in _step_strings(s):
                for match in _TOKEN_RE.finditer(value):
                    ref = match.group(2)
                    if ref is not None and ref not in reachable:
                        raise ValueError(
                            f"step {s.name!r} references "
                            f"${{steps.{ref}.output}} but does not depend "
                            f"on {ref!r} (declare it in dependencies)"
                        )

    def _check_acyclic(self) -> None:
        deps = {s.name: set(s.dependencies) for s in self.steps}
        done: set[str] = set()
        while deps:
            ready = [n for n, d in deps.items() if d <= done]
            if not ready:
                raise ValueError(
                    f"dependency cycle among steps {sorted(deps)}"
                )
            for n in ready:
                del deps[n]
                done.add(n)

    def step(self, name: str) -> StepSpec:
        for s in self.steps:
            if s.name == name:
                return s
        if self.on_exit is not None and self.on_exit.name == name:
            return self.on_exit
        raise KeyError(name)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "steps": [s.to_dict() for s in self.steps],
            "parallelism": self.parallelism,
        }
        if self.on_exit is not None:
            d["onExit"] = self.on_exit.to_dict()
        if self.artifacts_dir:
            d["artifactsDir"] = self.artifacts_dir
        if self.parameters:
            d["parameters"] = dict(self.parameters)
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "WorkflowSpec":
        steps, fanned = _expand_with_items(
            tuple(StepSpec.from_dict(s) for s in d.get("steps") or ())
        )
        spec = cls(
            steps=steps,
            on_exit=(
                StepSpec.from_dict(d["onExit"]) if d.get("onExit") else None
            ),
            artifacts_dir=d.get("artifactsDir", ""),
            parallelism=int(d.get("parallelism", 8)),
            parameters={
                str(k): str(v)
                for k, v in (d.get("parameters") or {}).items()
            },
        )
        if fanned:
            # `${steps.<group>.output}` has no single value once a step is
            # fanned out — catch it here with a targeted message (the
            # generic dependency check would fire with a confusing one).
            every = list(spec.steps) + (
                [spec.on_exit] if spec.on_exit else []
            )
            for s in every:
                for value in _step_strings(s):
                    for match in _TOKEN_RE.finditer(value):
                        if match.group(2) in fanned:
                            raise ValueError(
                                f"step {s.name!r} references the output of "
                                f"fanned-out step {match.group(2)!r}; "
                                "address an instance "
                                f"({match.group(2)}-0 ... "
                                f"{match.group(2)}-"
                                f"{len(fanned[match.group(2)]) - 1})"
                            )
        spec.validate()
        return spec


_TOKEN_RE = re.compile(
    r"\$\{workflow\.parameters\.([A-Za-z0-9_.-]+)\}"
    r"|\$\{steps\.([A-Za-z0-9_.-]+)\.output\}"
)


def _map_strings(node: Any, fn) -> Any:
    """Apply fn to every string in a nested dict/list structure — THE
    tree walker for all step templating (render, ${item} expansion);
    validators iterate the same shape via _iter_strings so the two can
    never disagree about what is templatable."""
    if isinstance(node, str):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_strings(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map_strings(v, fn) for v in node]
    return node


def _iter_strings(node: Any):
    if isinstance(node, str):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _iter_strings(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _iter_strings(v)


def _step_strings(s: "StepSpec"):
    """Every templatable string a step carries (incl. nested tpuJob)."""
    yield from (*s.command, *s.args, *(v for _, v in s.env), s.when)
    if s.tpu_job is not None:
        yield from _iter_strings(s.tpu_job)


def _expand_with_items(
    steps: tuple[StepSpec, ...],
) -> tuple[tuple[StepSpec, ...], dict[str, tuple[str, ...]]]:
    """Fan each `withItems` step into `<name>-<i>` instances with
    `${item}` substituted (Argo's withItems, the loop surface its CI DAGs
    shard suites with); dependencies on the group name are rewritten to
    all instances, so a downstream join waits for the whole fan."""
    rename: dict[str, tuple[str, ...]] = {}
    expanded: list[StepSpec] = []
    for s in steps:
        if not s.with_items:
            expanded.append(s)
            continue
        names = []
        for i, item in enumerate(s.with_items):
            sub = lambda text, item=item: text.replace("${item}", item)
            inst = dataclasses.replace(
                s,
                name=f"{s.name}-{i}",
                command=tuple(sub(c) for c in s.command),
                args=tuple(sub(a) for a in s.args),
                env=tuple((k, sub(v)) for k, v in s.env),
                when=sub(s.when),
                with_items=(),
                tpu_job=(
                    _map_strings(s.tpu_job, sub)
                    if s.tpu_job is not None
                    else None
                ),
            )
            names.append(inst.name)
            expanded.append(inst)
        rename[s.name] = tuple(names)
    if not rename:
        return tuple(expanded), {}
    out = []
    for s in expanded:
        deps: list[str] = []
        for dep in s.dependencies:
            deps.extend(rename.get(dep, (dep,)))
        out.append(dataclasses.replace(s, dependencies=tuple(deps)))
    return tuple(out), rename


def eval_when(
    expr: str,
    parameters: Mapping[str, str] | None = None,
    outputs: Mapping[str, str] | None = None,
) -> bool:
    """Minimal Argo-`when` evaluator: `A == B`, `A != B`, or a bare
    truthy token; operands are stripped of quotes and whitespace.

    The operator is parsed from the RAW (untemplated) expression —
    spec-author-controlled text — and the operands are rendered
    separately afterwards. Rendering first would let a step output that
    happens to contain `==`/`!=` re-shape the comparison (outputs are
    arbitrary pod-written strings). Anything fancier than one comparison
    belongs in the step itself."""
    parameters = parameters or {}
    outputs = outputs or {}

    def operand(raw: str) -> str:
        return render_value(raw, parameters, outputs).strip().strip("'\"")

    expr = expr.strip()
    if not expr:
        return True
    found = [
        (pos, op)
        for op in ("==", "!=")
        if (pos := expr.find(op)) >= 0
    ]
    if found:
        pos, op = min(found)
        lhs = operand(expr[:pos])
        rhs = operand(expr[pos + len(op):])
        return (lhs == rhs) if op == "==" else (lhs != rhs)
    return operand(expr).lower() not in ("false", "0")


def render_value(
    value: str,
    parameters: Mapping[str, str],
    outputs: Mapping[str, str],
    *,
    partial: bool = False,
) -> str:
    """Substitute `${workflow.parameters.<p>}` and `${steps.<s>.output}`
    in one string.

    One `re.sub` pass over the ORIGINAL string — substituted values are
    never rescanned, so an output that itself contains template-looking
    text cannot re-trigger (or fail) rendering. An unresolved reference
    raises — a typo'd parameter must fail loudly, not launch a step with
    a literal placeholder — unless `partial=True`, which substitutes what
    resolves and leaves the rest verbatim (the teardown path: a
    best-effort render beats none)."""

    def repl(match: re.Match) -> str:
        param_name, step_name = match.group(1), match.group(2)
        if param_name is not None and param_name in parameters:
            return parameters[param_name]
        if step_name is not None and step_name in outputs:
            return outputs[step_name]
        if partial:
            return match.group(0)
        raise ValueError(f"unresolved reference {match.group(0)!r}")

    return _TOKEN_RE.sub(repl, value)


def render_step(
    step: StepSpec,
    parameters: Mapping[str, str],
    outputs: Mapping[str, str],
    *,
    partial: bool = False,
) -> StepSpec:
    """The step with all templating applied to command/args/env values
    (and, for slice steps, every string inside the tpuJob spec).

    `outputs` maps step name → that step's reported output; the
    controller only creates a step after its dependencies succeeded, so
    every `${steps.<dep>.output}` a well-formed DAG references exists."""

    def render(text: str) -> str:
        return render_value(text, parameters, outputs, partial=partial)

    return dataclasses.replace(
        step,
        command=tuple(render(c) for c in step.command),
        args=tuple(render(a) for a in step.args),
        env=tuple((k, render(v)) for k, v in step.env),
        tpu_job=(
            _map_strings(step.tpu_job, render)
            if step.tpu_job is not None
            else None
        ),
    )
