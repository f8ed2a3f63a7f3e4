"""Merge per-shard junit XML into one suite: the artifact-collection
step of a fanned-out CI run.

A copy of `kubeflow_tpu/testing/junit_merge.py` (a module with no JAX in
it). The collector is the join of `testing/workflows.
sharded_unit_tests_workflow`, run as the final DAG step over the shared
artifacts directory:

    python -m kubeflow_tpu_torch.testing.junit_merge <dir> [-o merged.xml]

Exits non-zero when any merged suite contains failures/errors, so the
collect step's pod phase reflects the fan's overall verdict.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import xml.etree.ElementTree as ET


def merge(
    junit_dir: str | pathlib.Path, output: str | pathlib.Path | None = None
) -> tuple[int, int, int]:
    """Merge `junit_*.xml` under junit_dir; returns (tests, failures,
    errors). Writes `junit_merged.xml` (or `output`) in the same dir."""
    junit_dir = pathlib.Path(junit_dir)
    sources = sorted(
        p
        for p in junit_dir.glob("junit_*.xml")
        if p.name != "junit_merged.xml"
    )
    merged = ET.Element("testsuites")
    tests = failures = errors = 0
    for path in sources:
        root = ET.parse(path).getroot()
        suites = (
            [root] if root.tag == "testsuite"
            else list(root.iter("testsuite"))
        )
        for suite in suites:
            suite.set("file", path.name)
            merged.append(suite)
            tests += int(suite.get("tests", 0))
            failures += int(suite.get("failures", 0))
            errors += int(suite.get("errors", 0))
    merged.set("tests", str(tests))
    merged.set("failures", str(failures))
    merged.set("errors", str(errors))
    out_path = pathlib.Path(output) if output else junit_dir / "junit_merged.xml"
    ET.ElementTree(merged).write(out_path, xml_declaration=True)
    return tests, failures, errors


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="junit-merge")
    parser.add_argument("junit_dir")
    parser.add_argument("-o", "--output", default=None)
    args = parser.parse_args(argv)
    tests, fails, errs = merge(args.junit_dir, args.output)
    print(f"merged {tests} tests: {fails} failures, {errs} errors")
    return 1 if (fails or errs) else 0


if __name__ == "__main__":
    sys.exit(main())
