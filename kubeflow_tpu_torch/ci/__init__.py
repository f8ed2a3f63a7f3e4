"""CI utilities: the golden deploy manifests and image retagging
(`ci/application_util.py`), a copy of the JAX package's `ci/` without
its lint engine (`ci/lint/`), which is not ported yet.

    python -m kubeflow_tpu_torch.ci regenerate | check | render <bundle>
"""

from kubeflow_tpu_torch.ci.application_util import (
    manifest_drift,
    regenerate_manifests,
    render_bundle_yaml,
    render_overlaid_yaml,
    set_bundle_images,
)

__all__ = ["manifest_drift", "regenerate_manifests", "render_bundle_yaml",
           "render_overlaid_yaml", "set_bundle_images"]
