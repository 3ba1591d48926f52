"""pie_tpu_torch — the inference engine ported to PyTorch and CUDA.

A package beside the JAX package ``pie_tpu`` (the reference): the same
module layout and contracts, written in PyTorch, with every TPU kernel on
a ported path replaced by a kernel written by hand for NVIDIA Hopper
(``csrc/``). Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU, where the plain PyTorch version of each kernel
runs instead. Nothing here imports JAX or ``pie_tpu``.
"""

__version__ = "0.1.0"
