"""ttft_p50_ms: median time to first token from the due time, ms (host clock)."""

from portbench.readers import ttft_ms


def read(run):
    return ttft_ms(run, 50)
