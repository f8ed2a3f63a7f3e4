"""Manifest and image utilities for CI.

A copy of `kubeflow_tpu/ci/application_util.py` (a module with no JAX in
it), over the port's deploy bundles (`deploy/bundles.py`, the GPU
translation of JAX's): `set_bundle_images` retags component images
across rendered bundle resources; `regenerate_manifests` writes the
golden manifests, one YAML file per bundle, into
``kubeflow_tpu_torch/manifests/`` (the repository's root ``manifests/``
holds the JAX package's); `manifest_drift` names the bundles whose
checked-in golden differs from the generator; `render_overlaid_yaml`
renders one bundle through a chain of overlay files.

    python -m kubeflow_tpu_torch.ci regenerate | check | render <bundle> [--overlay F ...]

JAX's CLI also has ``lint`` (its lint engine, `ci/lint/`), which is not
ported yet.
"""

from __future__ import annotations

import pathlib

import yaml

from kubeflow_tpu_torch.deploy.bundles import BUNDLES
from kubeflow_tpu_torch.deploy.kfdef import PlatformSpec, default_spec

MANIFEST_DIR = pathlib.Path(__file__).resolve().parent.parent / "manifests"


def set_bundle_images(
    resources: list, image_map: dict[str, str]
) -> list:
    """Rewrite container image refs (`repo` or `repo:tag` keys in
    `image_map` → new ref) across rendered resources, in place."""
    from kubeflow_tpu_torch.deploy.overlays import split_image

    def rewrite(ref: str) -> str:
        if ref in image_map:
            return image_map[ref]
        # Registry-port/digest-aware repo extraction (shared with the
        # overlay engine's ImageRule).
        repo = split_image(ref)[0]
        return image_map.get(repo, ref)

    for res in resources:
        template = res.spec.get("template", {})
        for c in template.get("spec", {}).get("containers", []):
            if "image" in c:
                c["image"] = rewrite(c["image"])
        for c in res.spec.get("containers", []):
            if "image" in c:
                c["image"] = rewrite(c["image"])
    return resources


def _dump(resources) -> str:
    return yaml.safe_dump_all(
        [r.to_dict() for r in resources], sort_keys=True
    )


def render_bundle_yaml(
    name: str, spec: PlatformSpec | None = None
) -> str:
    return _dump(BUNDLES[name](spec or default_spec()))


def regenerate_manifests(
    out_dir: pathlib.Path | None = None,
) -> list[pathlib.Path]:
    """Write one YAML file per bundle (the checked-in golden set)."""
    out_dir = pathlib.Path(out_dir or MANIFEST_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for name in BUNDLES:
        path = out_dir / f"{name}.yaml"
        path.write_text(render_bundle_yaml(name))
        written.append(path)
    # Remove goldens for bundles that no longer exist.
    for stale in out_dir.glob("*.yaml"):
        if stale.stem not in BUNDLES:
            stale.unlink()
    return written


def manifest_drift(dir_: pathlib.Path | None = None) -> list[str]:
    """Bundle names whose checked-in golden differs from the generator
    (or is missing). Empty list = clean."""
    dir_ = pathlib.Path(dir_ or MANIFEST_DIR)
    drifted = []
    for name in BUNDLES:
        path = dir_ / f"{name}.yaml"
        if not path.exists() or path.read_text() != render_bundle_yaml(name):
            drifted.append(name)
    for stale in sorted(dir_.glob("*.yaml")):
        if stale.stem not in BUNDLES:
            drifted.append(stale.stem)
    return drifted


def render_overlaid_yaml(
    name: str,
    overlay_paths: list[str],
    spec: PlatformSpec | None = None,
) -> str:
    """One bundle rendered through a chain of overlay files — the
    `kustomize build <overlay-dir>` analog."""
    from kubeflow_tpu_torch.deploy.overlays import Overlay, apply_overlays

    return _dump(
        apply_overlays(
            BUNDLES[name](spec or default_spec()),
            [Overlay.load(p) for p in overlay_paths],
        )
    )


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="kubeflow-tpu-torch-ci")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("regenerate", help="rewrite kubeflow_tpu_torch/manifests/ from bundles")
    sub.add_parser("check", help="exit 1 if kubeflow_tpu_torch/manifests/ drifted")
    render = sub.add_parser(
        "render", help="print one bundle's YAML, optionally overlaid"
    )
    render.add_argument("bundle", choices=sorted(BUNDLES))
    render.add_argument(
        "--overlay", action="append", default=[],
        help="overlay YAML file (repeatable, applied in order)",
    )
    args = parser.parse_args(argv)

    if args.cmd == "render":
        print(render_overlaid_yaml(args.bundle, args.overlay), end="")
        return 0

    if args.cmd == "regenerate":
        for path in regenerate_manifests():
            print(f"wrote {path}")
        return 0
    drifted = manifest_drift()
    if drifted:
        print(
            "manifest drift (run `python -m kubeflow_tpu_torch.ci regenerate`): "
            + ", ".join(drifted)
        )
        return 1
    print("manifests clean")
    return 0
