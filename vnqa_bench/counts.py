"""The yardstick's arithmetic: the card's peaks, the least time a kernel launch
needs (operations and bytes from its shapes), and each configuration's
operations per video, counted from the model's shapes whatever implements
them.

The kernel counts follow the measured package's chip check (its per-kernel
"bound ms" column): each input byte read once, each output byte written once,
the operations the algorithm needs for these lengths.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # outside the tensor cores
BF16_FLOPS = 989e12      # tensor cores
INT8_OPS = 1979e12       # tensor cores

POSITIONS = 130          # 10 x 13 cells of a frame's stem features


def least_s(nbytes, ops, peak):
    """The least time for ``nbytes`` moved and ``ops`` done at ``peak``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


# --- kernels: one launch each -------------------------------------------------

def film_reencode(B, Tq, H, frames, q_lens):
    """The question re-encoded once per frame: F x sum(q_len) LSTM steps."""
    steps = frames * int(sum(q_lens))
    nbytes = Tq * B * 4 * H * 4 + 4 * H * H * 4 + 4 * H * 4 + B * 4 + frames * B * H * 4
    return least_s(nbytes, steps * (2 * 4 * H * H + 12 * H), F32_FLOPS)


def attn_tail(B, T, A, steps):
    """Softmax weights and context once per row (the step's rank-1 shift
    cancels), then ``steps`` LSTMCell steps."""
    nbytes = 4 * (B * T * A + 2 * B * T + 2 * 4 * A * A + 4 * A + B * steps * A)
    ops = B * (6 * T + 2 * T * A + 2 * 4 * A * A + 4 * A + steps * (2 * 4 * A * A + 12 * A))
    return least_s(nbytes, ops, F32_FLOPS)


def int8_matmul(M, K, N, x_bytes, requant=True):
    """The fused int8 1x1 conv: x [M, K] read at ``x_bytes`` an element, the
    int8 weight, scales and bias, y [M, N] bf16 written, and its int8 codes."""
    nbytes = M * K * x_bytes + N * K + 2 * N * 4 + 8 + M * N * 2 + (M * N if requant else 0)
    return least_s(nbytes, 2 * M * K * N, INT8_OPS)


def vgg_block1(M):
    """VGG block 1 over M frames: bf16 pixels in, pooled bf16 [80, 104, 64] out."""
    ops = M * 2 * 160 * 208 * 64 * (27 + 576)
    nbytes = M * 160 * 208 * 3 * 2 + 64 * (27 + 576) * 2 + 2 * 64 * 4 + M * 80 * 104 * 64 * 2
    return least_s(nbytes, ops, BF16_FLOPS)


# --- models: operations per video ---------------------------------------------

def conv_ops(h, w, cin, cout, k):
    return 2 * h * w * cin * cout * k * k


def stem_ops_per_frame(filters=512):
    """The frozen stem of one 160 x 208 frame (VGG-16 to conv2_2, the detector's
    three conv pairs)."""
    vgg = (conv_ops(160, 208, 3, 64, 3) + conv_ops(160, 208, 64, 64, 3)
           + conv_ops(80, 104, 64, 128, 3) + conv_ops(80, 104, 128, 128, 3))
    det = (conv_ops(40, 52, 128, filters, 3) + conv_ops(40, 52, filters, filters, 3)
           + 2 * conv_ops(20, 26, filters, filters, 3) + 2 * conv_ops(10, 13, filters, filters, 3))
    return vgg + det


def lstm_ops(steps, inp, hidden):
    return steps * (2 * 4 * hidden * (inp + hidden) + 12 * hidden)


def film_attn_least_s(cfg, v_len, q_len, *, stem):
    """Least seconds of film_attn_pt's eval forward of one video with v_len
    frames and q_len words: the trunk's convs at the int8 peak, the rest at
    the bf16 peak (with ``stem``, the frozen stem's too)."""
    C, Cin, N = cfg["num_res_block_channels"], cfg["num_input_channels"], cfg["num_res_blocks"]
    E, Hq, A = cfg["embed_size"], cfg["hidden_size"], cfg["at_hidden_size"]
    steps = cfg["max_num_frames"]
    trunk = v_len * (conv_ops(10, 13, Cin, C, 3)
                     + N * (conv_ops(10, 13, C, C, 1) + conv_ops(10, 13, C, C, 3)))
    rest = (2 * q_len * E * 4 * Hq                          # the token projection
            + v_len * lstm_ops(q_len, 0, Hq)                # the re-encode's recurrence
            + v_len * 2 * Hq * 2 * C * N                    # FiLM decoder
            + v_len * (2 * POSITIONS * C * A + 2 * A)       # frame embedding, score
            + steps * (2 * A + 4 * v_len * A + lstm_ops(1, A, A))   # attention tail
            + 2 * steps * A * cfg["num_classes"])
    if stem:
        rest += v_len * stem_ops_per_frame(Cin)
    return trunk / INT8_OPS + rest / BF16_FLOPS


def mac_forward_ops(cfg, v_len, q_len):
    """MAC's forward over one video (without the stem)."""
    d, E, Cin, S = cfg["mac_dim"], cfg["embed_size"], cfg["num_input_channels"], \
        cfg["mac_max_step"]
    question = 2 * lstm_ops(q_len, E, d) + q_len * 2 * 2 * d * d
    know = conv_ops(10, 13, Cin, d, 3) + 2 * conv_ops(10, 13, d, d, 3) \
        + 2 * POSITIONS * d * d                             # the read's cell-side product
    step = (2 * 2 * d * d                                   # control_question
            + 4 * q_len * d                                 # word attention and context
            + 2 * d * d                                     # read_mem
            + 2 * POSITIONS * d * d                         # (memory x cells) product
            + 4 * POSITIONS * d                             # read attention and readout
            + 2 * 2 * d * d)                                # write
    per_video = S * 2 * 2 * d * d                           # position-aware projections
    tail = lstm_ops(v_len, 3 * d, 3 * d) + 2 * 3 * d * 2 * d + 2 * 2 * d * cfg["num_classes"]
    return question + per_video + v_len * (know + S * step) + tail


def mac_train_least_s(cfg, v_len, q_len):
    """Least seconds of one video's MAC train step: forward and backward (three
    forwards' work) and the frozen stem's forward, all at the bf16 peak."""
    ops = 3 * mac_forward_ops(cfg, v_len, q_len) + v_len * stem_ops_per_frame(
        cfg["num_input_channels"])
    return ops / BF16_FLOPS
