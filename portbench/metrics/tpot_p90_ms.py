"""tpot_p90_ms: 90th percentile over requests of the time per output token after the first, ms (host clock)."""

from portbench.readers import tpot_ms


def read(run):
    return tpot_ms(run, 90)
