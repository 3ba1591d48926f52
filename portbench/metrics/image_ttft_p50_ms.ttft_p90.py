"""image_ttft_p50_ms.ttft_p90: median time to first token, from the due time, of the requests that carry an image, ms (host clock)."""

from portbench.readers import image_ttft_ms


def read(run):
    return image_ttft_ms(run, 50)
