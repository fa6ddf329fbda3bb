"""PyTorch/CUDA port of the M2-ViT reproduction (the JAX package ``repro``
is the reference it is held against).

The main path is the paper's flow on EfficientViT:
``recipe.quantize(arch, params, "m2q-w8a8")`` -> ``QuantizedModel.forward``
/ ``QuantizedModel.serve`` (a
:class:`~repro_torch.serving.vision.VisionEngine`).
Its three hot ops run hand-written CUDA kernels for Hopper (``csrc/``),
each beside a plain PyTorch version of the same function
(``kernels/``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
