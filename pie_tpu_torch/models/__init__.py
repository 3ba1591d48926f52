"""Model zoo: config parsing, registry, architectures."""

from pie_tpu_torch.models.registry import get_model_class, register_model
