"""token_gap_p99_ms.tpot_p90: 99th percentile of the gaps between consecutive tokens of a request, over all requests in the window, ms (host clock)."""

from portbench.readers import token_gap_ms


def read(run):
    return token_gap_ms(run, 99)
