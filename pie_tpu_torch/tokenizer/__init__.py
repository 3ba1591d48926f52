"""Tokenizer wrapper, control-token registry, and chat templating."""

from pie_tpu_torch.tokenizer.control_tokens import (
    ControlTokens,
    get_control_tokens,
)
from pie_tpu_torch.tokenizer.tokenizer import Tokenizer, load_tokenizer
