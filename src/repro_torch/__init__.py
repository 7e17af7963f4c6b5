"""repro_torch — the data-movement system on PyTorch and an NVIDIA H100.

A port of the JAX package ``repro`` (which stays beside it as the
reference): the same module layout and names, PyTorch idiom inside, and a
hand-written Hopper kernel for each Pallas kernel on the ported path.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
