"""User-facing application backends, the web tier: copies of the JAX
package's `kubeflow_tpu/apps/` (modules with no JAX in them), each an
`App` on `kubeflow_tpu_torch.web`:

- `kfam`: access management, profiles and contributor bindings;
- `jupyter`: the notebook spawner's backend;
- `tensorboards`: Tensorboard CRUD;
- `dashboard`: the central hub API and the workgroup registration flow;
- `staticserver`: a file server for platform config;
- `probe`: the availability prober and its /metrics app
  (``python -m kubeflow_tpu_torch.apps.probe --url U``);
- `echo`: the echo server that reflects a request, its identity included
  (``python -m kubeflow_tpu_torch.apps.echo [PORT]``);
- `cloud_metrics`: the dashboard's Cloud Monitoring metrics service,
  its requests sent through `deploy/gke.py`'s transport seam;
- `__main__`: the platform in a box, ``python -m kubeflow_tpu_torch.apps``.
"""
