"""MAC (Hudson & Manning, arXiv:1803.03067) as VideoNavQA trains it
(arXiv:1908.04950), plain, with its train step.

  question: Embedding -> biLSTM(dim) -> Linear(2dim -> dim) per word
  per frame: 3 x [conv3x3 -> ELU] knowledge grid (130 cells x dim), then
            ``max_step`` MAC steps (control attention over the words, read
            attention over the cells, write), variational dropout on the
            control and the memory (one mask a forward, the same at each step)
  tail:     LSTM(3dim) over [memory, question state] per frame -> last valid
            state -> Linear -> ELU -> Linear

The knowledge convs compute in bfloat16, the rest in float32. The train step
is the reference harness's for MAC: mean cross-entropy, each gradient element
clamped to +-1, the global norm clipped to 1, then Adam.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vnqa_bench.reference.ops import (
    REF, conv2d, cross_entropy_mean, exact_f32, linear, matmul, packed_lstm)


def shapes(cfg):
    d, E, Cin = cfg["mac_dim"], cfg["embed_size"], cfg["num_input_channels"]
    lstm = lambda i, h: {"w_ih": (4 * h, i), "w_hh": (4 * h, h), "b_ih": (4 * h,),
                         "b_hh": (4 * h,)}
    lin = lambda o, i: {"weight": (o, i), "bias": (o,)}
    conv = lambda o, i: {"weight": (o, i, 3, 3), "bias": (o,)}
    mac = {"position_aware": [lin(d, 2 * d) for _ in range(cfg["mac_max_step"])],
           "control_question": lin(d, 2 * d), "control_attn": lin(1, d),
           "read_mem": lin(d, d), "read_concat": lin(d, 2 * d), "read_attn": lin(1, d),
           "write_concat": lin(d, 2 * d), "mem_0": (1, d), "control_0": (1, d)}
    params = {"embed": {"weight": (cfg["vocab_size"], E)}, "lstm_fwd": lstm(E, d),
              "lstm_bwd": lstm(E, d), "lstm_proj": lin(d, 2 * d), "conv0": conv(d, Cin),
              "conv1": conv(d, d), "conv2": conv(d, d), "mac": mac,
              "classifier0": lin(2 * d, 3 * d), "classifier2": lin(cfg["num_classes"], 2 * d),
              "lstm_tail": lstm(3 * d, 3 * d)}
    return params, {}


def dropout_masks(generator, rows, dim, keep, device):
    """(control, memory) masks [rows, dim] of bernoulli(keep) / keep, drawn in
    one call from ``generator``."""
    probs = torch.full((2, rows, dim), keep, dtype=torch.float32, device=device)
    masks = torch.bernoulli(probs, generator=generator) / keep
    return masks[0], masks[1]


def _reverse(x, lens):
    """Each row of x [B, T, ...] reversed within its first lens[b] positions."""
    B, T = x.shape[:2]
    t = torch.arange(T, device=x.device)[None, :]
    n = lens.long()[:, None]
    idx = torch.where(t < n, n - 1 - t, t)
    return x[torch.arange(B, device=x.device)[:, None], idx]


def forward(params, feats, q, q_lens, v_lens, cfg, masks=None, prec=REF):
    """logits [B, num_classes] of MAC over features [B, T, 10, 13, Cin]."""
    B, T = feats.shape[:2]
    d = cfg["mac_dim"]
    Tq = q.shape[1]
    emb = params["embed"]["weight"].float()[q.long()]
    out_f, h_f, _ = packed_lstm(params["lstm_fwd"], emb, q_lens, prec=prec)
    out_b, h_b, _ = packed_lstm(params["lstm_bwd"], _reverse(emb, q_lens), q_lens, prec=prec)
    word_live = (torch.arange(Tq, device=q.device)[None, :] < q_lens[:, None])[..., None]
    out_b = torch.where(word_live, _reverse(out_b, q_lens), 0.0)
    context = linear(params["lstm_proj"], torch.cat([out_f, out_b], dim=-1), prec)
    question = torch.cat([h_f, h_b], dim=-1)
    word_mask = torch.where(torch.arange(Tq, device=q.device) < q_lens.max(), 0.0,
                            -torch.inf)[None, :]

    x = feats.reshape(B * T, *feats.shape[2:])
    for name in ("conv0", "conv1", "conv2"):
        x = F.elu(conv2d(params[name], x, torch.bfloat16, fp8=prec.convs_fp8))
    know = x.reshape(B * T, -1, d).float()
    N = B * T
    rep = lambda a: a.repeat_interleave(T, dim=0)
    ctx_n = rep(context)
    mac = params["mac"]
    control = mac["control_0"].float().expand(N, d)
    memory = mac["mem_0"].float().expand(N, d)
    c_mask, m_mask = masks if masks is not None else (None, None)
    if masks is not None:
        control, memory = control * c_mask, memory * m_mask
    w_read = mac["read_concat"]["weight"]
    know_part = matmul(know, w_read[:, d:].t(), prec) + mac["read_concat"]["bias"].float()
    for i in range(cfg["mac_max_step"]):
        pa = rep(linear(mac["position_aware"][i], question, prec))
        cq = linear(mac["control_question"], torch.cat([control, pa], dim=1), prec)
        logits = linear(mac["control_attn"], cq[:, None, :] * ctx_n, prec)[..., 0] + word_mask
        control = matmul(torch.softmax(logits, dim=1)[:, None, :], ctx_n, prec)[:, 0]
        if c_mask is not None:
            control = control * c_mask
        mem = linear(mac["read_mem"], memory, prec)
        concat = matmul(mem[:, None, :] * know, w_read[:, :d].t(), prec) + know_part
        rattn = torch.softmax(linear(mac["read_attn"], concat * control[:, None, :],
                                     prec)[..., 0], dim=1)
        read = matmul(rattn[:, None, :], know, prec)[:, 0]
        memory = linear(mac["write_concat"], torch.cat([read, memory], dim=1), prec)
        if m_mask is not None:
            memory = memory * m_mask
    outs = torch.cat([memory, rep(question)], dim=1).reshape(B, T, 3 * d)
    frame_live = (torch.arange(T, device=q.device)[None, :] < v_lens[:, None])[..., None]
    tail, _, _ = packed_lstm(params["lstm_tail"], torch.where(frame_live, outs, 0.0), v_lens,
                             prec=prec)
    last = tail[torch.arange(B, device=q.device), (v_lens.long() - 1).clamp(0, T - 1)]
    return linear(params["classifier2"], F.elu(linear(params["classifier0"], last, prec)), prec)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def train_steps(params, batches, features_of, cfg, step_seeds, *, lr, clamp=1.0, clip=1.0,
                prec=REF, device=None):
    """The reference harness's MAC train steps from ``params`` (a tree of f32
    tensors, copied here) over ``batches`` (dicts with video, question, q_len,
    v_len, label). -> (the first step's log-probabilities, losses, the first
    step's gradient norm of each leaf as Adam takes it, each leaf's final
    params)."""
    leaves = [t.detach().clone().float().requires_grad_(True) for t in tree_leaves(params)]
    tree = _rebuild(params, iter(leaves))
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first_norms, first_log_probs = [], None, None
    keep = 1.0 - cfg["mac_dropout"]
    with exact_f32():
        for step, (batch, seed) in enumerate(zip(batches, step_seeds), start=1):
            with torch.no_grad():
                feats = features_of(batch["video"])
            B, T = feats.shape[:2]
            gen = torch.Generator(device=device).manual_seed(seed)
            masks = dropout_masks(gen, B * T, cfg["mac_dim"], keep, feats.device)
            logits = forward(tree, feats, batch["question"], batch["q_len"], batch["v_len"],
                             cfg, masks, prec)
            loss = cross_entropy_mean(logits, batch["label"])
            if first_log_probs is None:
                first_log_probs = torch.log_softmax(logits.detach().float(), dim=-1)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            grads = [g.clamp(-clamp, clamp) for g in grads]
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            scale = torch.clamp(clip / torch.clamp(norm, min=1e-6), max=1.0)
            grads = [g * scale for g in grads]
            if first_norms is None:
                first_norms = [float(g.norm()) for g in grads]
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for p, g, mi, vi in zip(leaves, grads, m, v):
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                    denom = (vi.sqrt() / bc2 ** 0.5).add_(eps)
                    p.addcdiv_(mi, denom, value=-lr / bc1)
    return first_log_probs, losses, first_norms, [p.detach() for p in leaves]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)
