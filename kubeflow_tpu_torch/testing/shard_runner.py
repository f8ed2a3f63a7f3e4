"""Run one CI test shard: pytest over a target, junit into the shared
artifacts directory under a filesystem-safe name.

A copy of `kubeflow_tpu/testing/shard_runner.py` (a module with no JAX
in it): the fan-out step of `testing/workflows.
sharded_unit_tests_workflow`.

    python -m kubeflow_tpu_torch.testing.shard_runner <target> [--junit-dir D] \
        [--pytest-args "-q --noconftest"]
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys


def safe_name(target: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", target)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="shard-runner")
    parser.add_argument("target")
    parser.add_argument("--junit-dir", default="")
    parser.add_argument(
        "--pytest-args", default="-q", help="extra pytest flags (split on space)"
    )
    args = parser.parse_args(argv)
    cmd = [sys.executable, "-m", "pytest", args.target,
           *args.pytest_args.split()]
    if args.junit_dir:
        cmd.append(
            f"--junitxml={args.junit_dir}/junit_{safe_name(args.target)}.xml"
        )
    return subprocess.call(cmd)


if __name__ == "__main__":
    sys.exit(main())
