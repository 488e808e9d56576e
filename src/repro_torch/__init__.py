"""ZC² on PyTorch and CUDA: the port of the ``repro`` package.

The port runs a retrospective query end to end on an NVIDIA card and
scores operators through the hand-written kernel in
``kernels/csrc/conv_scorer.cu``. It imports neither JAX nor ``repro``:
modules that ``repro`` keeps free of JAX are copied here, so each module
of this package has its counterpart at the same path under ``repro``.

Entry points run on the card (``device=None`` means ``cuda``) and raise
where there is none; the CPU is used only when a caller passes
``device="cpu"``, as the tests do.
"""
