"""The kit of a dense pre-norm decoder (Mistral / Llama, and the text
decoder of Qwen2-VL / Qwen2.5-VL): its weights (``weights.py``), its plain
reference (``reference/decoder.py``) and its model FLOPs (``counts.py``).
A request carries no inputs beside its token ids."""

from __future__ import annotations

from portbench import counts, weights
from portbench.reference.decoder import Decoder


def state_dict(cfg: dict, seed: int, device) -> dict:
    return weights.state_dict(cfg, seed, device)


def decoder(cfg: dict, seed: int, device, precision: str = "f32") -> Decoder:
    """The decoder reference over the seed's weights, layer by layer."""
    a = cfg["assumed"]
    return Decoder(cfg, lambda i: weights.layer_weights(cfg, seed, i, device),
                   lambda: weights.top_weights(cfg, seed, device),
                   group=a["weight_group_size"], bits=a["weight_bits"],
                   precision=precision)


class Reference:
    def __init__(self, cfg: dict, seed: int, device, precision: str = "f32"):
        self.decoder = decoder(cfg, seed, device, precision)

    def logits(self, requests: list, rows: list) -> list:
        if any(extras for _, extras in requests):
            raise ValueError("a dense decoder's requests carry no inputs")
        return self.decoder.logits([ids for ids, _ in requests], rows)


def reference(cfg: dict, seed: int, device, precision: str = "f32") -> Reference:
    return Reference(cfg, seed, device, precision)


decode_token_flops = counts.decode_token_flops
prefill_flops = counts.prefill_flops


def rider_flops(cfg: dict, tokens: int) -> float:
    """A rider slice's projections over its tokens (attention not counted)."""
    return 2 * counts.layer_params(cfg) * tokens


def call_flops(cfg: dict, call: dict) -> float:
    raise ValueError(f"a dense decoder records no calls beside its steps: {call}")
