"""The deploy tier's cloud seam: a cut-down copy of the JAX package's
`kubeflow_tpu/deploy/` holding only `gke.py`'s transport (`Request`,
`Transport`, `RecordingTransport`), which `apps/cloud_metrics.py` sends
its requests through. Not copied: the provisioner, the GKE node-pool
payloads, the deploy server and its worker."""
