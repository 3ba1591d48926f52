"""The breakdown tools of the port's kernels (``pie_tpu_torch/tools/``)
build variants of a kernel by editing lines of its shipped source. These
checks hold each tool to the source it edits, on the CPU, so that an edit
of a ``.cu`` file that a tool no longer matches fails here and not first
on the card."""

import pytest

from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.tools import k1_breakdown, k2_breakdown, k3_sweep, k4_breakdown

TOOLS = {"k1_breakdown": (k1_breakdown, "quant_gemv.cu"),
         "k2_breakdown": (k2_breakdown, "quant_gemm.cu"),
         "k3_sweep": (k3_sweep, "paged_attention.cu"),
         "k4_breakdown": (k4_breakdown, "fused_mlp.cu")}


@pytest.mark.parametrize("name", list(TOOLS))
def test_variant_sources_accept_the_shipped_kernel(name):
    """Each tool's variant_sources takes the kernel source as it ships,
    keeps it as the ``kernel`` entry, and yields variants that each differ
    from it and from one another."""
    tool, source = TOOLS[name]
    src = (qmc.CSRC / source).read_text()
    variants = tool.variant_sources(src)
    assert variants.pop("kernel") == src
    assert variants and all(text != src for text in variants.values())
    assert len(set(variants.values())) == len(variants)


@pytest.mark.parametrize("name", list(TOOLS))
def test_variant_sources_refuse_a_source_without_their_lines(name):
    """A source that lacks the lines a tool edits is refused with an error
    that names the source, not turned into variants equal to the kernel."""
    tool, source = TOOLS[name]
    with pytest.raises(RuntimeError, match=source.split(".")[0]):
        tool.variant_sources("// a kernel source without the edited lines\n")
