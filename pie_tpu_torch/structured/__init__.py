"""Constrained / structured generation.

Reference parity: the external PSE (Proxy Structuring Engine) capability the
reference depends on (SURVEY.md §2.4: StructuringEngine.configure /
process_logits / sample / get_labeled_output, state machines) plus the
reference's own RootStateMachine orchestration (state_machine/root.py:17-125)
— re-built self-contained: a host-side character-level JSON-schema automaton
compiles per-step token masks that the device applies as logit masks.
"""

from pie_tpu_torch.structured.json_machine import JsonMachine
from pie_tpu_torch.structured.token_masks import TokenMasker
from pie_tpu_torch.structured.root import RootStateMachine, StructuredState
