"""Models: the flat `TransformerLM` and its weight conversion."""

from kubeflow_tpu_torch.models.convert import from_flax, init_params
from kubeflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM

__all__ = ["TransformerConfig", "TransformerLM", "from_flax", "init_params"]
