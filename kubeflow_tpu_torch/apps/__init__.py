"""User-facing application backends, the web tier: copies of the JAX
package's `kubeflow_tpu/apps/` (modules with no JAX in them), each an
`App` on `kubeflow_tpu_torch.web`:

- `kfam`: access management, profiles and contributor bindings;
- `jupyter`: the notebook spawner's backend;
- `tensorboards`: Tensorboard CRUD;
- `dashboard`: the central hub API and the workgroup registration flow;
- `staticserver`: a file server for platform config;
- `__main__`: the platform in a box, ``python -m kubeflow_tpu_torch.apps``.

Not copied: `probe`, `cloud_metrics` and `echo` (ROADMAP lists them).
"""
