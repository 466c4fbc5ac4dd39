"""MAC network over the frozen stem (the port of models/mac.py).

  question: Embedding (no padding_idx) -> biLSTM(dim) -> lstm_proj(2dim -> dim)
  per frame: 3 x [conv3x3 -> ELU] knowledge grid (512 -> dim at 10x13 = 130
             cells) -> 12-step MAC recurrence (control attention over words,
             read attention over knowledge cells, write) -> concat(memory, q_h)
  tail: LSTM(3dim) over frames -> last valid state -> Linear -> ELU -> Linear

The recurrence carries nothing across frames, so all frames fold into one
[B*T] batch; only the tail LSTM runs over frames. The write unit's
self-attention and memory-gate variants are off in the reference, as here
(below). Control attention runs over the batch's max question length; padded
words within it see context = the lstm_proj bias.

With ``cfg.use_pallas_kernels`` the eval forward's three LSTM passes
(biLSTM forward and backward, tail) launch the LSTM kernel; the train forward
runs them plain, through autograd, as the JAX package does (the kernel has no
backward pass). Training also applies variational dropout (``cfg.mac_dropout``):
one control mask and one memory mask over the folded rows, drawn once a
forward from the caller's generator and applied at every step; and, whenever
autograd records, each step is recomputed in the backward pass instead of
keeping its [N, 130, dim] read activations (JAX's ``jax.checkpoint``).

The write unit's two variants of the reference, off there and here
(``SELF_ATTENTION``, ``MEMORY_GATE``; each adds its parameters to the init):
self-attention adds ``write_mem`` of the memories attended by the new
control over the earlier controls, and the gate mixes the memory before the
step back in, ``g * m_prev + (1 - g) * m_new`` with ``g`` a sigmoid of the
new control. With either on, the cell keeps its control and memory histories
and recomputes no step, as the JAX cell does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from videonavqa_tpu_torch.models.base import DTYPES, register_model
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.conv import conv2d
from videonavqa_tpu_torch.ops.linear import embedding, linear
from videonavqa_tpu_torch.ops.lstm import bilstm, last_valid, lstm
from videonavqa_tpu_torch.ops.masking import mask_invalid, word_softmax_mask
from videonavqa_tpu_torch.parallel.collectives import batch_rows, like_sharded, take_rows
from videonavqa_tpu_torch.utils.device import tree_to

SELF_ATTENTION = False
MEMORY_GATE = False


def init_fn(gen, cfg, device):
    dim = cfg.mac_dim
    params = {
        "embed": {"weight": init.uniform(gen, (cfg.vocab_size, cfg.embed_size), 0.0, 1.0)},
        "lstm_fwd": init.torch_default_lstm(gen, cfg.embed_size, dim),
        "lstm_bwd": init.torch_default_lstm(gen, cfg.embed_size, dim),
        "lstm_proj": init.torch_default_linear(gen, dim, 2 * dim),
        # knowledge convs: kaiming for the first two, torch's default for the third
        "conv0": {"weight": init.kaiming_uniform(gen, (dim, cfg.num_input_channels, 3, 3), "oihw"),
                  "bias": torch.zeros(dim)},
        "conv1": {"weight": init.kaiming_uniform(gen, (dim, dim, 3, 3), "oihw"),
                  "bias": torch.zeros(dim)},
        "conv2": init.torch_default_conv2d(gen, 3, 3, dim, dim),
    }
    params["mac"] = {
        "position_aware": [init.reference_linear(gen, dim, 2 * dim)
                           for _ in range(cfg.mac_max_step)],
        "control_question": init.reference_linear(gen, dim, 2 * dim),
        "control_attn": init.reference_linear(gen, 1, dim),
        "read_mem": init.reference_linear(gen, dim, dim),
        "read_concat": init.reference_linear(gen, dim, 2 * dim),
        "read_attn": init.reference_linear(gen, 1, dim),
        "write_concat": init.reference_linear(gen, dim, 2 * dim),
        "mem_0": torch.zeros((1, dim)),
        "control_0": torch.zeros((1, dim)),
    }
    params["classifier0"] = {"weight": init.kaiming_uniform(gen, (2 * dim, 3 * dim), "oi"),
                             "bias": torch.zeros(2 * dim)}
    params["classifier2"] = init.reference_linear(gen, cfg.num_classes, 2 * dim)
    params["lstm_tail"] = init.torch_default_lstm(gen, 3 * dim, 3 * dim)
    # drawn last, so the other parameters are the same with a variant on
    if SELF_ATTENTION:
        params["mac"]["write_attn"] = init.reference_linear(gen, 1, dim)
        params["mac"]["write_mem"] = init.reference_linear(gen, dim, dim)
    if MEMORY_GATE:
        params["mac"]["write_control"] = init.reference_linear(gen, 1, dim)
    return tree_to(params, device), {}


def variational_masks(generator, n, dim, keep, device):
    """(control mask, memory mask), each [n, dim] f32 of bernoulli(keep) / keep.
    Without ``generator``, one on ``device`` seeded 0 (the JAX model falls
    back to PRNGKey(0))."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    keep_probs = torch.full((2, n, dim), keep, dtype=torch.float32, device=device)
    masks = torch.bernoulli(keep_probs, generator=generator) / keep
    return masks[0], masks[1]


def mac_recurrence(mac, context, question, know, word_mask, frames, cfg, masks=None):
    """The MAC cell's ``cfg.mac_max_step`` steps over the folded N = B*frames rows.

    context [B, Tq, dim] projected biLSTM states, question [B, 2*dim] biLSTM
    final states (each row serves its ``frames`` folded rows), know
    [N, P, dim] knowledge grid (cells by channels), word_mask [1, Tq],
    masks None or the (control, memory) dropout masks [N, dim]
    -> memory [N, dim].

    The read unit's Linear over concat(mem * know, know) splits into a part
    that changes per step, (mem * know) W_a^T, and one that does not,
    know W_b^T + bias, computed once. The masks come in drawn: a draw inside
    a recomputed step would differ from the forward's (checkpoint restores
    only the default generators' state)."""
    N, _, dim = know.shape
    rep = lambda a: a.repeat_interleave(frames, dim=0)
    context_n = rep(context)
    control = mac["control_0"].float().expand(N, dim)
    memory = mac["mem_0"].float().expand(N, dim)
    control_mask, memory_mask = masks if masks is not None else (None, None)
    if masks is not None:
        control, memory = control * control_mask, memory * memory_mask
    w_read = mac["read_concat"]["weight"].float()
    # column slices of a weight whose rows may be split over 'model'
    know_part = linear({"weight": like_sharded(w_read[:, dim:], w_read),
                        "bias": mac["read_concat"]["bias"]}, know)
    w_mem_part = {"weight": like_sharded(w_read[:, :dim], w_read)}

    def control_unit(i, control, control_mask):
        # attention over the words
        pa = rep(linear(mac["position_aware"][i], question))
        cq = linear(mac["control_question"], torch.cat([control, pa], dim=1))
        logits = linear(mac["control_attn"], cq[:, None, :] * context_n)[..., 0] + word_mask
        control = torch.einsum("nt,ntd->nd", torch.softmax(logits, dim=1), context_n)
        return control if control_mask is None else control * control_mask

    def read_unit(memory, control):
        # attention over the knowledge cells, from the memory before the
        # write and the control just updated
        mem = linear(mac["read_mem"], memory)
        concat = linear(w_mem_part, mem[:, None, :] * know).add_(know_part)   # [N, P, dim]
        rattn = torch.softmax(linear(mac["read_attn"], concat.mul_(control[:, None, :]))[..., 0],
                              dim=1)
        return torch.einsum("np,npd->nd", rattn, know)

    def step(i, control, memory, control_mask, memory_mask):
        control = control_unit(i, control, control_mask)
        memory = linear(mac["write_concat"], torch.cat([read_unit(memory, control), memory], dim=1))
        if memory_mask is not None:
            memory = memory * memory_mask
        return control, memory

    if not (SELF_ATTENTION or MEMORY_GATE):
        for i in range(cfg.mac_max_step):
            if torch.is_grad_enabled():
                control, memory = checkpoint(step, i, control, memory, control_mask,
                                             memory_mask, use_reentrant=False)
            else:
                control, memory = step(i, control, memory, control_mask, memory_mask)
        return memory

    # the write unit's variants read the control and memory histories
    controls, memories = [control], [memory]
    for i in range(cfg.mac_max_step):
        control = control_unit(i, control, control_mask)
        memory = linear(mac["write_concat"],
                        torch.cat([read_unit(memories[-1], control), memories[-1]], dim=1))
        if SELF_ATTENTION:
            # the new control attends over the earlier ones, and the memory
            # takes the memories of those steps under that attention
            a = linear(mac["write_attn"], control[:, None, :] * torch.stack(controls, dim=1))
            a = torch.softmax(a[..., 0], dim=1)                          # [N, S]
            attended = torch.einsum("ns,nsd->nd", a, torch.stack(memories, dim=1))
            memory = linear(mac["write_mem"], attended) + memory
        if MEMORY_GATE:
            gate = torch.sigmoid(linear(mac["write_control"], control))   # [N, 1]
            memory = gate * memories[-1] + (1 - gate) * memory
        if memory_mask is not None:
            memory = memory * memory_mask
        controls.append(control)
        memories.append(memory)
    return memory


def apply_fn(params, state, batch, cfg, *, train=False, generator=None):
    feats, v_lens = batch["v_features"], batch["v_len"]
    q, q_lens = batch["question"], batch["q_len"]
    B, T = feats.shape[:2]
    dim = cfg.mac_dim
    use_kernel = cfg.use_pallas_kernels and not train

    emb = embedding(params["embed"], q)
    lstm_out, h = bilstm(params["lstm_fwd"], params["lstm_bwd"], emb, q_lens,
                         use_kernel=use_kernel)
    context = linear(params["lstm_proj"], lstm_out)   # [B, Tq, dim]; pads -> bias rows
    word_mask = word_softmax_mask(q_lens, q.shape[1])

    x = feats.reshape(B * T, *feats.shape[2:])
    for name in ("conv0", "conv1", "conv2"):
        x = F.elu(conv2d(params[name], x, dtype=DTYPES[cfg.compute_dtype]))
    know = x.reshape(B * T, -1, dim).float()          # [B*T, 130, dim]

    masks = None
    if train and cfg.mac_dropout > 0:
        # drawn over the global batch's rows; this rank takes its own
        masks = variational_masks(generator, batch_rows(B * T)[0], dim, 1.0 - cfg.mac_dropout,
                                  feats.device)
        masks = tuple(take_rows(m, B * T) for m in masks)
    memory = mac_recurrence(params["mac"], context, h, know, word_mask, T, cfg, masks)
    outs = torch.cat([memory, h.repeat_interleave(T, dim=0)], dim=1).reshape(B, T, 3 * dim)
    tail, _ = lstm(params["lstm_tail"], mask_invalid(outs, v_lens), v_lens,
                   use_kernel=use_kernel)
    out = F.elu(linear(params["classifier0"], last_valid(tail, v_lens)))
    return linear(params["classifier2"], out), state


register_model("mac", init_fn, apply_fn,
               needs_video=True, needs_question=True, uses_stem=True)
