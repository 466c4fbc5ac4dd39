"""VideoNavQA in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``videonavqa_tpu`` (JAX/XLA/Pallas). The JAX package stays the
reference; this package imports nothing of it and no JAX. Module names follow
the JAX package's so each function's counterpart is easy to find:

- ``ops/``      — plain PyTorch ops (linear, masking, masked LSTM, eval
                  BatchNorm, conv, int8 quantization).
- ``kernels/``  — one module per ported Pallas kernel: a CUDA C++ kernel in
                  ``csrc/`` bound with ctypes, its plain PyTorch version and
                  a launch counter.
- ``models/``   — ``ModelConfig``, the registry and six zoo models.
- ``stem/``     — the frozen visual stem: VGG-16 partial (block 1 through
                  the fused ``vgg_block1`` kernel, or plain) and the object
                  detector's features.
- ``train/``    — the train step, the eval forward and step, the loss and
                  the metrics.
- ``serve/``    — ``InferenceEngine`` over precomputed frozen-stem features
                  (a feature cache) or from raw uint8 video through the stem,
                  the micro-batcher, the daemon's HTTP handler and a
                  load generator for it.
- ``data/``     — datasets on disk, the Python and native (VNR) batch
                  loaders, frame buckets, prefetching to the card.
- ``cli/``      — the training harness and its entry points
                  (``q_and_v_eval``, ``v_only_eval``, ``q_only_eval``), the
                  serving ones (``extract_features``, ``serve``, ``predict``)
                  and the dataset tools (``generate_dataset``,
                  ``dataset_stats``, ``make_synthetic_data``,
                  ``pack_dataset``, ``train_obj_detector``).
- ``datagen/``  — a copy of the JAX package's dataset generator (numpy and
                  scipy): the synthetic houses and their renderer,
                  trajectories, question templates and programs, the
                  answer-balancing engine, the tokenizer, labels, splits,
                  statistics and the House3D seam.
- ``utils/``    — constants, checkpoints in the JAX package's format (both
                  ways, with Adam's state), the stem's importers, JSONL
                  metrics and device selection.

Public tensors keep the JAX layouts: video ``[B, T, 160, 208, 3]`` and
features ``[B, T, 10, 13, C]`` (channels last), questions ``[B, 56]``. Conv
weights are OIHW (bridged from HWIO).
"""

__version__ = "0.1.0"
