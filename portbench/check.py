"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, a sample of the
requests the service finished inside the window, drawn from the seed with
the longest of them always in it (and, where requests carry inputs such as
images, the longest of those too), is run through the plain reference of
the configuration's kit (``kit.py``; ``reference/``) once over each prompt
with its served tokens and its inputs.
The number compared is the widest gap by which a served token's reference
logit lies below the reference's best at its position (greedy decoding
serves the program's best; a sound program misses the reference's best
only on near-ties). Where the cell's check sets ``features_gap_limit``,
also the widest gap between the prompt embeddings the program served for
a sampled request with inputs (its rows over the inputs' placeholders, as
the service made them in the window: ``harness.record_embeddings``) and
the reference's features there, over the reference's largest: the stage
that turns inputs into embeddings, judged apart from the logits it feeds.
Beside them, two exact counts: finished requests that did not yield
exactly the tokens they asked for, and requests that failed.

The limits and the sample's size are the cell's: ``checks/<workload>.json``
holds them, with the readings they were set from.
"""

from __future__ import annotations

import numpy as np

CHECK_SALT = 0x5EED_C0DE


def sample(run, seed: int, tokens: int) -> list:
    """Finished requests to judge: the longest (prompt + served), and the
    longest of those that carry inputs, then others in an order drawn from
    the seed until ``tokens`` served tokens."""
    done = [r for r in run.sent if r.finished and r.finished <= run.t_close
            and not r.error]
    if not done:
        return []
    done.sort(key=lambda r: r.index)
    size = lambda r: (len(r.prompt) + len(r.tokens), -r.index)  # noqa: E731
    picked = [max(done, key=size)]
    with_inputs = [r for r in done if r.extras]
    if with_inputs and not picked[0].extras:
        picked.append(max(with_inputs, key=size))
    rest = [r for r in done if all(r is not p for p in picked)]
    order = np.random.default_rng((int(seed) ^ CHECK_SALT) & ((1 << 63) - 1))
    total = sum(len(p.tokens) for p in picked)
    for i in order.permutation(len(rest)):
        if total >= tokens:
            break
        picked.append(rest[i])
        total += len(rest[i].tokens)
    return picked


def reference_gaps(ref, picked: list, device) -> tuple:
    """(widest gap over the picked requests' served tokens, tokens compared,
    the reference's logits per request), by a kit's reference ``ref``."""
    import torch

    from portbench.reference.decoder import widest_gap

    reqs, rows, served = [], [], []
    for r in picked:
        plen = len(r.prompt)
        reqs.append((torch.tensor(r.prompt + r.tokens[:-1], device=device), r.extras))
        rows.append(torch.arange(plen - 1, plen - 1 + len(r.tokens), device=device))
        served.append(torch.tensor(r.tokens, device=device))
    logits = ref.logits(reqs, rows)
    gap = max((widest_gap(lg, tok) for lg, tok in zip(logits, served)), default=0.0)
    return gap, sum(len(r.tokens) for r in picked), logits


def features_gap(ref, picked: list, embeds: dict) -> tuple:
    """(widest gap over the picked requests that carry inputs, how many):
    for each, the largest distance between a served embedding over its
    inputs' placeholders and the reference's feature there, over the
    reference's largest feature; a request whose embeddings were not kept
    reads as served zeros."""
    import torch

    with_inputs = [r for r in picked if r.extras]
    want = ref.features([(torch.tensor(r.prompt), r.extras) for r in with_inputs])
    worst = 0.0
    for r, (rows, feats) in zip(with_inputs, want):
        got = embeds.get(r.index)
        got = (torch.zeros_like(feats) if got is None
               else got[rows.to(got.device)].to(feats.device, torch.float32))
        worst = max(worst, float((got - feats).abs().max() / feats.abs().max()))
    return worst, len(with_inputs)


def compare(run, cfg: dict, spec: dict, seed: int, device) -> dict:
    """Each number compared, with its limit and whether it holds."""
    picked = sample(run, seed, spec["sample_tokens"])
    ref = run.kit.reference(cfg, seed, device) if picked else None
    gap, n, _ = reference_gaps(ref, picked, device) if picked else (0.0, 0, None)
    done = [r for r in run.sent if r.finished and r.finished <= run.t_close]
    short = sum(1 for r in done if len(r.tokens) != r.max_tokens)
    failed = sum(1 for r in run.sent if r.error)
    out = {
        "widest_gap": dict(value=gap, limit=spec["widest_gap_limit"], holds="<=",
                           ok=bool(n) and gap <= spec["widest_gap_limit"]),
    }
    if "features_gap_limit" in spec:
        fgap, m = features_gap(ref, picked, run.embeds) if picked else (0.0, 0)
        out["features_gap"] = dict(value=fgap, limit=spec["features_gap_limit"], holds="<=",
                                   ok=bool(m) and fgap <= spec["features_gap_limit"])
    out.update({
        "tokens_compared": dict(value=n, limit=spec["min_tokens_compared"], holds=">=",
                                ok=n >= spec["min_tokens_compared"]),
        "short_requests": dict(value=short, limit=0, holds="<=", ok=short == 0),
        "failed_requests": dict(value=failed, limit=0, holds="<=", ok=failed == 0),
    })
    return out
