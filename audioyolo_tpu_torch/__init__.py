"""audioyolo_tpu_torch: the PyTorch + CUDA port of audioyolo_tpu.

The layout mirrors the JAX package (``config``, ``ops``, ``models``,
``infer``, ``data``, ``train``); hand-written Hopper kernels and the native
audio library live in ``csrc/`` and are built at first use
(``ops/build.py``). The package imports torch, numpy and
yaml, never JAX or the JAX package. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""
