"""Benchmark-wide numeric constants (a copy of videonavqa_tpu/utils/constants.py).

They define the VideoNavQA task geometry and are part of the public contract:

- videos are 160x208 BGR at 10 fps, at most 400 raw frames;
- the loader keeps one random frame per 4-frame bucket, into a fixed 35-frame
  container;
- questions are <=56 tokens over a 134-token vocabulary (0 = pad);
- answers are a 70-way classification.
"""

DROP_EVERY_N_FRAMES = 4
MAX_ALLOWED_NUM_FRAMES_DROPPING = 35
MAX_NUM_VIDEO_FRAMES = 400
MAX_Q_LEN = 56
NUM_CLASSES = 70
VID_HEIGHT = 160
VID_WIDTH = 208
VOCAB_SIZE = 134

# Frozen-stem feature geometry: VGG-16 partial -> 128ch @ 40x52, ObjDetectCNN ->
# 512ch @ 10x13.
STEM_OUT_CHANNELS = 512
STEM_OUT_H = 10
STEM_OUT_W = 13
STEM_OUT_POSITIONS = STEM_OUT_H * STEM_OUT_W  # 130

# Attention mask fill value.
NEG_MASK_VALUE = -float(1 << 31)

# Frame-axis trim targets of length-bucketed batches.
FRAME_BUCKETS = (8, 12, 16, 20, 24, 28, 32, 35)
