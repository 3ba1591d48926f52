"""Composable character machines for multi-state constrained generation.

Reference parity: the PSE state graph the reference composes in
RootStateMachine._create_state_graph (reference state_machine/root.py:66-125)
— FreeformStateMachine with end delimiters, ReasoningState (think tags),
ToolCallState, StructuredOutputState, combined by AnyStateMachine
(sub_states/__init__.py:1-13). Here each is a small NFA over the same
protocol as :class:`~pie_tpu_torch.structured.json_machine.JsonMachine`:

    allowed_chars() -> set[str]     (ANY_CHAR = "anything")
    advance(text) -> bool           (consume, False = rejected, unchanged)
    accepts_prefix(text) -> bool    (lookahead, no mutation)
    is_complete -> bool
    copy() / reset()
    name                            (sub-state label for sampler overrides)

so TokenMasker and the engine's constrained loop work with any of them.
"""

from __future__ import annotations

from typing import Optional, Sequence

ANY_CHAR = "\x00"


class LiteralMachine:
    """Accepts exactly one fixed string."""

    name = "literal"

    def __init__(self, literal: str):
        if not literal:
            raise ValueError("literal must be non-empty")
        self.literal = literal
        self.pos = 0
        self.text = ""

    def reset(self):
        self.pos = 0
        self.text = ""

    def allowed_chars(self) -> set:
        if self.pos >= len(self.literal):
            return set()
        return {self.literal[self.pos]}

    def advance(self, text: str) -> bool:
        end = self.pos + len(text)
        if end > len(self.literal):
            return False
        if self.literal[self.pos : end] != text:
            return False
        self.pos = end
        self.text += text
        return True

    def accepts_prefix(self, text: str) -> bool:
        end = self.pos + len(text)
        return end <= len(self.literal) and self.literal[self.pos : end] == text

    @property
    def is_complete(self) -> bool:
        return self.pos == len(self.literal)

    def copy(self) -> "LiteralMachine":
        m = LiteralMachine.__new__(LiteralMachine)
        m.literal, m.pos, m.text = self.literal, self.pos, self.text
        return m


class FreeformMachine:
    """Free text terminated by one of ``end_delimiters`` (reference
    FreeformStateMachine with stop-sequence end delimiters,
    state_machine/root.py:99-104). With no delimiters the machine accepts
    everything and is complete after ``min_chars`` characters."""

    name = "text"

    def __init__(self, end_delimiters: Sequence[str] = (), min_chars: int = 0):
        self.delims = tuple(end_delimiters)
        self.min_chars = min_chars
        self.text = ""
        self._done = False

    def reset(self):
        self.text = ""
        self._done = False

    def allowed_chars(self) -> set:
        if self._done:
            return set()
        return {ANY_CHAR}

    def advance(self, text: str) -> bool:
        if self._done and text:
            return False
        self.text += text
        for d in self.delims:
            if self.text.endswith(d):
                self._done = True
        return True

    def accepts_prefix(self, text: str) -> bool:
        return not (self._done and text)

    def is_unconstrained(self) -> bool:
        """True while ANY token string is acceptable (the engine skips mask
        construction entirely for such steps)."""
        return not self._done

    @property
    def is_complete(self) -> bool:
        if self.delims:
            return self._done
        return len(self.text) >= self.min_chars

    @property
    def body(self) -> str:
        """Generated text with the terminating delimiter stripped."""
        for d in self.delims:
            if self.text.endswith(d):
                return self.text[: -len(d)]
        return self.text

    def copy(self) -> "FreeformMachine":
        m = FreeformMachine.__new__(FreeformMachine)
        m.delims, m.min_chars = self.delims, self.min_chars
        m.text, m._done = self.text, self._done
        return m


class SequenceMachine:
    """Parts consumed in order (NFA over (part_index, part_state): a
    complete part hands the next character to its successor, keeping both
    branches alive when continuation is ambiguous)."""

    name = "sequence"

    def __init__(self, parts: Sequence, names: Optional[Sequence[str]] = None):
        if not parts:
            raise ValueError("sequence needs parts")
        self._protos = [p.copy() for p in parts]
        self.part_names = list(
            names or [getattr(p, "name", "part") for p in parts]
        )
        self.reset()

    def reset(self):
        for p in self._protos:
            p.reset()
        self.states = [(0, self._protos[0].copy())]
        self.text = ""

    def _fanout(self, states):
        """Add successor-part states for every complete part."""
        out = list(states)
        frontier = list(states)
        while frontier:
            i, m = frontier.pop()
            if m.is_complete and i + 1 < len(self._protos):
                nxt = self._protos[i + 1].copy()
                nxt.reset()
                out.append((i + 1, nxt))
                frontier.append((i + 1, nxt))
        return out

    def allowed_chars(self) -> set:
        chars: set = set()
        for i, m in self._fanout(self.states):
            chars |= m.allowed_chars()
        return chars

    def is_unconstrained(self) -> bool:
        return any(
            getattr(m, "is_unconstrained", lambda: False)()
            for _, m in self._fanout(self.states)
        )

    def advance(self, text: str) -> bool:
        states = self.states
        for ch in text:
            new = []
            for i, m in self._fanout(states):
                m2 = m.copy()
                if m2.advance(ch):
                    new.append((i, m2))
            if not new:
                return False
            states = new
        self.states = states
        self.text += text
        return True

    def accepts_prefix(self, text: str) -> bool:
        saved_states, saved_text = self.states, self.text
        self.states = [(i, m.copy()) for i, m in self.states]
        ok = self.advance(text)
        self.states, self.text = saved_states, saved_text
        return ok

    @property
    def is_complete(self) -> bool:
        last = len(self._protos) - 1
        return any(
            i == last and m.is_complete
            for i, m in self._fanout(self.states)
        )

    def active_names(self) -> set:
        return {self.part_names[i] for i, _ in self.states}

    def copy(self) -> "SequenceMachine":
        m = SequenceMachine.__new__(SequenceMachine)
        m._protos = self._protos
        m.part_names = self.part_names
        m.states = [(i, s.copy()) for i, s in self.states]
        m.text = self.text
        return m


class AnyMachine:
    """Union of alternatives: characters advance every branch that accepts
    them; complete when any branch is (reference AnyStateMachine
    composition, state_machine/root.py:121-125)."""

    name = "any"

    def __init__(self, parts: Sequence, names: Optional[Sequence[str]] = None):
        if not parts:
            raise ValueError("any needs parts")
        self._protos = [p.copy() for p in parts]
        self.part_names = list(
            names or [getattr(p, "name", "part") for p in parts]
        )
        self.reset()

    def reset(self):
        for p in self._protos:
            p.reset()
        self.branches = [(i, p.copy()) for i, p in enumerate(self._protos)]
        self.text = ""

    def allowed_chars(self) -> set:
        chars: set = set()
        for _, b in self.branches:
            chars |= b.allowed_chars()
        return chars

    def is_unconstrained(self) -> bool:
        return any(
            getattr(b, "is_unconstrained", lambda: False)()
            for _, b in self.branches
        )

    def advance(self, text: str) -> bool:
        new = []
        for i, b in self.branches:
            b2 = b.copy()
            if b2.advance(text):
                new.append((i, b2))
        if not new:
            return False
        self.branches = new
        self.text += text
        return True

    def accepts_prefix(self, text: str) -> bool:
        return any(b.accepts_prefix(text) for _, b in self.branches)

    @property
    def is_complete(self) -> bool:
        return any(b.is_complete for _, b in self.branches)

    def active_names(self) -> set:
        return {self.part_names[i] for i, _ in self.branches}

    def copy(self) -> "AnyMachine":
        m = AnyMachine.__new__(AnyMachine)
        m._protos = self._protos
        m.part_names = self.part_names
        m.branches = [(i, b.copy()) for i, b in self.branches]
        m.text = self.text
        return m


def reasoning_machine(
    output_machine=None,
    open_tag: str = "<think>",
    close_tag: str = "</think>",
    stop: Sequence[str] = (),
    output_name: str = None,
):
    """<think>...</think> followed by the output machine (reference
    ReasoningState + structured/tool state composed in the root graph,
    state_machine/sub_states/__init__.py:1-13). ``output_name`` labels the
    output part for active_names()-keyed sampler switching."""
    parts = [
        LiteralMachine(open_tag),
        FreeformMachine(end_delimiters=(close_tag,)),
    ]
    names = ["reasoning", "reasoning"]
    if output_machine is not None:
        parts.append(output_machine)
        names.append(
            output_name or getattr(output_machine, "name", "output")
        )
    else:
        parts.append(FreeformMachine(end_delimiters=tuple(stop), min_chars=1))
        names.append(output_name or "text")
    return SequenceMachine(parts, names=names)
