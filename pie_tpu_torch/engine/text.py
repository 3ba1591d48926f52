"""Host-side text utilities for generation: incremental detokenization and
stop-sequence handling (reference generate() stop handling,
engine/inference_engine.py:204-224, done at the text layer)."""

from __future__ import annotations

from typing import Optional, Sequence


class IncrementalDecoder:
    """Streams text from token ids, holding back bytes until UTF-8 stable."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.ids: list[int] = []
        self._emitted = ""

    def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        text = self.tokenizer.decode(self.ids)
        # hold back a trailing replacement char (partial UTF-8 sequence)
        while text.endswith("�"):
            text = text[:-1]
        new = text[len(self._emitted):]
        self._emitted = text
        return new

    @property
    def text(self) -> str:
        return self._emitted


class StopSequenceMatcher:
    """Detects stop strings across token boundaries; buffers text that could
    be the start of a stop sequence so it is never emitted."""

    def __init__(self, stop_sequences: Sequence[str]):
        self.stops = [s for s in stop_sequences if s]
        self.buffer = ""
        self.stopped = False
        self.tail = ""

    def push(self, text: str) -> str:
        """Feed new text; returns the emittable portion (empty if buffered).
        After a stop hit, `stopped` is True and everything before the stop
        is returned."""
        if self.stopped:
            return ""
        if not self.stops:
            return text
        self.buffer += text
        # full stop match?
        first = None
        for s in self.stops:
            i = self.buffer.find(s)
            if i != -1 and (first is None or i < first[0]):
                first = (i, s)
        if first is not None:
            self.stopped = True
            out = self.buffer[: first[0]]
            self.buffer = ""
            return out
        # emit all but the longest suffix that is a prefix of some stop
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.buffer)), 0, -1):
                if self.buffer.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        out = self.buffer[: len(self.buffer) - hold]
        self.buffer = self.buffer[len(self.buffer) - hold:]
        return out

    def flush(self) -> str:
        out, self.buffer = self.buffer, ""
        return out


def parse_tool_calls(text: str) -> Optional[list[dict]]:
    """Best-effort extraction of tool calls from generated text: a JSON
    object {"name":..., "arguments":...} or an array of them."""
    import json

    t = text.strip()
    if t.startswith("```"):
        t = t.strip("`")
        if t.startswith("json"):
            t = t[4:]
        t = t.strip()
    if not (t.startswith("{") or t.startswith("[")):
        return None
    try:
        data = json.loads(t)
    except json.JSONDecodeError:
        return None
    items = data if isinstance(data, list) else [data]
    calls = []
    for it in items:
        if not isinstance(it, dict) or "name" not in it:
            return None
        args = it.get("arguments", it.get("parameters", {}))
        calls.append({"name": it["name"], "arguments": args})
    return calls or None
