"""VideoNavQA in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``videonavqa_tpu`` (JAX/XLA/Pallas). The JAX package stays the
reference; this package imports nothing of it and no JAX. Module names follow
the JAX package's so each function's counterpart is easy to find:

- ``ops/``      — plain PyTorch ops (linear, masking, masked LSTM, eval
                  BatchNorm, conv, int8 quantization).
- ``kernels/``  — one module per ported Pallas kernel: a CUDA C++ kernel in
                  ``csrc/`` bound with ctypes, its plain PyTorch version and
                  a launch counter.
- ``models/``   — ``ModelConfig``, the registry and six zoo models (eval).
- ``stem/``     — the frozen visual stem: VGG-16 partial (block 1 through
                  the fused ``vgg_block1`` kernel, or plain) and the object
                  detector's features.
- ``train/``    — the eval forward.
- ``serve/``    — ``InferenceEngine`` over precomputed frozen-stem features,
                  or from raw uint8 video through the stem (``from_video``).
- ``utils/``    — constants, the JAX-checkpoint weight bridge and device
                  selection.

Public tensors keep the JAX layouts: video ``[B, T, 160, 208, 3]`` and
features ``[B, T, 10, 13, C]`` (channels last), questions ``[B, 56]``. Conv
weights are OIHW (bridged from HWIO).
"""

__version__ = "0.1.0"
