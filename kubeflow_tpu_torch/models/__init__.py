"""Models: the `TransformerLM` (flat or switch-MoE, with its remat
policies), the `ResNet` family, and their weight conversion."""

from kubeflow_tpu_torch.models.convert import from_flax, init_params, resnet_from_flax
from kubeflow_tpu_torch.models.resnet import ResNet, resnet18, resnet50, tiny_resnet
from kubeflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM

__all__ = [
    "ResNet",
    "TransformerConfig",
    "TransformerLM",
    "from_flax",
    "init_params",
    "resnet18",
    "resnet50",
    "resnet_from_flax",
    "tiny_resnet",
]
