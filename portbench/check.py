"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, a sample of the
requests the service finished inside the window, drawn from the seed with
the longest of them always in it, is run through the plain reference
(``reference/decoder.py``) once over each prompt with its served tokens.
The number compared is the widest gap by which a served token's reference
logit lies below the reference's best at its position (greedy decoding
serves the program's best; a sound program misses the reference's best
only on near-ties). Beside it, two exact counts: finished requests that
did not yield exactly the tokens they asked for, and requests that failed.

The limits and the sample's size are the cell's: ``checks/<workload>.json``
holds them, with the readings they were set from.
"""

from __future__ import annotations

import numpy as np

CHECK_SALT = 0x5EED_C0DE


def sample(run, seed: int, tokens: int) -> list:
    """Finished requests to judge: the longest (prompt + served), then others
    in an order drawn from the seed until ``tokens`` served tokens."""
    done = [r for r in run.sent if r.finished and r.finished <= run.t_close
            and not r.error]
    if not done:
        return []
    done.sort(key=lambda r: r.index)
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens), -r.index))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng((int(seed) ^ CHECK_SALT) & ((1 << 63) - 1))
    picked, total = [longest], len(longest.tokens)
    for i in order.permutation(len(rest)):
        if total >= tokens:
            break
        picked.append(rest[i])
        total += len(rest[i].tokens)
    return picked


def reference_gaps(cfg: dict, seed: int, picked: list, device,
                   precision: str = "f32") -> tuple:
    """(widest gap over the picked requests' served tokens, tokens compared,
    the reference's logits per request)."""
    import torch

    from portbench import weights
    from portbench.reference.decoder import Decoder, widest_gap

    a = cfg["assumed"]
    ref = Decoder(cfg, lambda i: weights.layer_weights(cfg, seed, i, device),
                  lambda: weights.top_weights(cfg, seed, device),
                  group=a["weight_group_size"], bits=a["weight_bits"],
                  precision=precision)
    seqs, rows, served = [], [], []
    for r in picked:
        plen = len(r.prompt)
        seqs.append(torch.tensor(r.prompt + r.tokens[:-1], device=device))
        rows.append(torch.arange(plen - 1, plen - 1 + len(r.tokens), device=device))
        served.append(torch.tensor(r.tokens, device=device))
    logits = ref.logits(seqs, rows)
    gap = max((widest_gap(lg, tok) for lg, tok in zip(logits, served)), default=0.0)
    return gap, sum(len(r.tokens) for r in picked), logits


def compare(run, cfg: dict, spec: dict, seed: int, device) -> dict:
    """Each number compared, with its limit and whether it holds."""
    picked = sample(run, seed, spec["sample_tokens"])
    gap, n, _ = reference_gaps(cfg, seed, picked, device) if picked else (0.0, 0, None)
    done = [r for r in run.sent if r.finished and r.finished <= run.t_close]
    short = sum(1 for r in done if len(r.tokens) != r.max_tokens)
    failed = sum(1 for r in run.sent if r.error)
    return {
        "widest_gap": dict(value=gap, limit=spec["widest_gap_limit"], holds="<=",
                           ok=bool(n) and gap <= spec["widest_gap_limit"]),
        "tokens_compared": dict(value=n, limit=spec["min_tokens_compared"], holds=">=",
                                ok=n >= spec["min_tokens_compared"]),
        "short_requests": dict(value=short, limit=0, holds="<=", ok=short == 0),
        "failed_requests": dict(value=failed, limit=0, holds="<=", ok=failed == 0),
    }
