"""Tokenizer wrapper around HF tokenizers.

Reference parity: tokenizer/tokenizer.py:20-154 — encode/decode, chat
templating with control tokens, stop-token ids, control-token whitelist for
the structured-generation engine.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Optional, Sequence

from pie_tpu_torch.interaction import Interaction
from pie_tpu_torch.tokenizer.chat_template import render_chat
from pie_tpu_torch.tokenizer.control_tokens import ControlTokens, get_control_tokens

logger = logging.getLogger(__name__)


class Tokenizer:
    def __init__(
        self,
        hf_tokenizer,
        control_tokens: Optional[ControlTokens] = None,
    ):
        self._tok = hf_tokenizer
        eos = getattr(hf_tokenizer, "eos_token", None)
        self.control_tokens = control_tokens or get_control_tokens(
            eos_token=eos
        )
        self._bos_id = getattr(hf_tokenizer, "bos_token_id", None)

    # -- core ----------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self._bos_id is not None:
            ids = [self._bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._tok.convert_tokens_to_ids(token)
        unk = getattr(self._tok, "unk_token_id", None)
        if tid is None or (unk is not None and tid == unk and token != getattr(self._tok, "unk_token", None)):
            return None
        return tid

    # -- chat ----------------------------------------------------------

    #: sentinel marking an image slot in rendered chat text; never part of
    #: any real vocabulary, replaced by image-token runs after rendering
    IMAGE_SENTINEL = "\x00<pie:image>\x00"

    def apply_chat_template(
        self,
        interactions: Sequence[Interaction | dict],
        add_generation_prompt: bool = True,
        tools: Optional[list[dict]] = None,
        add_bos: bool = True,
        image_token_id: Optional[int] = None,
        tokens_per_image: int = 0,
    ) -> list[int]:
        """Render + encode a conversation. When ``image_token_id`` is given,
        each image attached to a message (Interaction image content, or dict
        key "num_images") becomes ``tokens_per_image`` copies of that id
        preceding the message text — the placeholder run that
        ``embed_with_images`` scatters vision features over (reference
        models/gemma/ensemble.py:108-157 image-token merge)."""
        msgs = []
        for it in interactions:
            if isinstance(it, Interaction):
                role, text = it.role.value, it.text
                n_img = len(it.images)
            else:
                role = it["role"]
                text = it.get("text", it.get("content", ""))
                n_img = int(
                    it.get("num_images", len(it.get("images") or []))
                )
            if n_img and image_token_id is not None:
                text = self.IMAGE_SENTINEL * n_img + text
            msgs.append({"role": role, "text": text})
        text = render_chat(
            msgs, self.control_tokens, add_generation_prompt, tools
        )
        if image_token_id is None or self.IMAGE_SENTINEL not in text:
            return self.encode(text, add_bos=add_bos)
        ids: list[int] = []
        for i, piece in enumerate(text.split(self.IMAGE_SENTINEL)):
            if i:
                ids.extend([image_token_id] * tokens_per_image)
            if piece:
                ids.extend(self.encode(piece, add_bos=(add_bos and i == 0)))
            elif i == 0 and add_bos and self._bos_id is not None:
                ids.append(self._bos_id)
        return ids

    # -- stop / control tokens -----------------------------------------

    @property
    def stop_tokens(self) -> list[int]:
        """Ids of end-of-turn / end-of-message / eos tokens (reference
        tokenizer/tokenizer.py stop_tokens surface)."""
        out = []
        for s in self.control_tokens.stop_token_strings:
            tid = self.token_to_id(s)
            if tid is not None:
                out.append(tid)
        eos_id = getattr(self._tok, "eos_token_id", None)
        if eos_id is not None and eos_id not in out:
            out.append(eos_id)
        return out

    @property
    def whitelist_control_tokens(self) -> list[str]:
        """Control tokens the structured-generation engine may emit."""
        c = self.control_tokens
        return [t for t in (c.end_of_turn, c.end_of_message) if t]


def load_tokenizer(model_path: str | Path, **kw) -> Tokenizer:
    from transformers import AutoTokenizer

    hf_tok = AutoTokenizer.from_pretrained(str(model_path), **kw)
    return Tokenizer(hf_tok)
