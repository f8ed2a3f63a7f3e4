"""CI workflow definitions: the reference's CI DAGs as Workflow CRs.

A copy of `kubeflow_tpu/testing/workflows.py` (a module with no JAX in
it). Each builder returns a ``Workflow`` for the port's workflow
controller (`controllers/workflow.py`); the local pod runner runs each
step as a process (``python -m pytest`` in place of a container image).

The specs are JAX's once its module names and test paths are mapped to
the port's: modules ``kubeflow_tpu.X`` are ``kubeflow_tpu_torch.X``
(`testing/junit_merge`, `testing/shard_runner`, `deploy`), the lint step
compiles ``kubeflow_tpu_torch``, and each pytest target is the port's
counterpart of JAX's file (`TARGETS`):

    tests/                ->  tests/  (the whole suite, which holds the
                              port's tests/test_torch_*.py beside the
                              reference's)
    tests/test_deploy.py  ->  tests/test_torch_deploy.py
    tests/test_serving.py ->  tests/test_torch_serving.py
    tests/test_study.py   ->  tests/test_torch_study.py

One addition: `sharded_unit_tests_workflow(pytest_args=)` passes each
shard's pytest flags through `shard_runner --pytest-args` (JAX's shards
take the runner's default, ``-q``), which a shard on a machine without
JAX needs (``-q --noconftest``: tests/conftest.py imports JAX).
"""

from __future__ import annotations

import sys

from kubeflow_tpu_torch.api.objects import Resource, new_resource
from kubeflow_tpu_torch.api.workflow import KIND, StepSpec, WorkflowSpec

# JAX's pytest target -> the port's counterpart.
TARGETS = {
    "tests/": "tests/",
    "tests/test_deploy.py": "tests/test_torch_deploy.py",
    "tests/test_serving.py": "tests/test_torch_serving.py",
    "tests/test_study.py": "tests/test_torch_study.py",
}


def _pytest_step(
    name: str,
    target: str,
    *,
    dependencies: tuple[str, ...] = (),
    junit_dir: str = "",
    retries: int = 0,
) -> StepSpec:
    args = ["-m", "pytest", target, "-q"]
    if junit_dir:
        args += [f"--junitxml={junit_dir}/junit_{name}.xml"]
    return StepSpec(
        name=name,
        command=(sys.executable,),
        args=tuple(args),
        dependencies=dependencies,
        retries=retries,
    )


def unit_tests_workflow(
    name: str = "unit-tests",
    namespace: str = "kubeflow-ci",
    *,
    artifacts_dir: str = "",
) -> Resource:
    """The unit-test DAG: lint and the unit suite in parallel, junit into
    the shared artifacts directory."""
    spec = WorkflowSpec(
        steps=(
            _pytest_step("test-core", TARGETS["tests/"], junit_dir=artifacts_dir),
            StepSpec(
                name="lint",
                command=(sys.executable, "-m", "compileall", "-q"),
                args=("kubeflow_tpu_torch",),
            ),
        ),
        artifacts_dir=artifacts_dir,
    )
    return new_resource(KIND, name, namespace, spec=spec.to_dict())


def sharded_unit_tests_workflow(
    shards: tuple[str, ...],
    name: str = "unit-tests-sharded",
    namespace: str = "kubeflow-ci",
    *,
    artifacts_dir: str = "",
    collect_required: bool = True,
    pytest_args: str = "",
) -> Resource:
    """Fan-out CI: one pytest pod per shard (`withItems`), junit XML into
    the shared artifacts directory, then a collect step that merges the
    shards' junit into one suite and fails if any test failed.
    `collect_required=False` guards the collect step with a `when` on
    the ``collect`` parameter. `pytest_args`, when given, are every
    shard's pytest flags (`shard_runner --pytest-args`)."""
    if not artifacts_dir:
        raise ValueError(
            "sharded CI needs an artifacts_dir — junit collection is the "
            "point of the join step"
        )
    collect = StepSpec(
        name="collect-junit",
        command=(sys.executable, "-m", "kubeflow_tpu_torch.testing.junit_merge"),
        args=(artifacts_dir,),
        dependencies=("shard",),
        when="" if collect_required
        else "${workflow.parameters.collect} == true",
    )
    shard_args = ("${item}", "--junit-dir", artifacts_dir)
    if pytest_args:
        shard_args += ("--pytest-args", pytest_args)
    spec = WorkflowSpec(
        steps=(
            StepSpec(
                name="shard",
                command=(
                    sys.executable, "-m",
                    "kubeflow_tpu_torch.testing.shard_runner",
                ),
                args=shard_args,
                with_items=tuple(shards),
            ),
            collect,
        ),
        artifacts_dir=artifacts_dir,
        parameters={} if collect_required else {"collect": "true"},
    )
    return new_resource(KIND, name, namespace, spec=spec.to_dict())


def platform_e2e_workflow(
    name: str = "platform-e2e",
    namespace: str = "kubeflow-ci",
    *,
    artifacts_dir: str = "",
    deploy_args: tuple[str, ...] = (),
) -> Resource:
    """The platform e2e DAG: deploy the platform, assert readiness, run
    the conformance suites, tear down in the exit handler no matter
    what."""
    py = sys.executable
    spec = WorkflowSpec(
        steps=(
            StepSpec(
                name="deploy",
                command=(py, "-m", "kubeflow_tpu_torch.deploy", "apply"),
                args=deploy_args,
                retries=2,
            ),
            _pytest_step(
                "kf-is-ready",
                TARGETS["tests/test_deploy.py"],
                dependencies=("deploy",),
                junit_dir=artifacts_dir,
            ),
            _pytest_step(
                "serving-golden",
                TARGETS["tests/test_serving.py"],
                dependencies=("deploy",),
                junit_dir=artifacts_dir,
            ),
            _pytest_step(
                "studyjob",
                TARGETS["tests/test_study.py"],
                dependencies=("deploy",),
                junit_dir=artifacts_dir,
            ),
        ),
        on_exit=StepSpec(
            name="teardown",
            command=(py, "-m", "kubeflow_tpu_torch.deploy", "delete"),
            args=deploy_args,
        ),
        artifacts_dir=artifacts_dir,
    )
    return new_resource(KIND, name, namespace, spec=spec.to_dict())
