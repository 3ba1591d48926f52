"""Utilities: metrics, device selection."""

from pie_tpu_torch.utils.device import resolve_device
from pie_tpu_torch.utils.metrics import Metrics, get_metrics
