"""Train the ObjDetectCNN stem as a 27-way multi-label object detector (the
port of the JAX package's cli/train_obj_detector.py).

The reference trains this model offline and uses it frozen through
``obj_detect.pt``; this trains it here, on top of the frozen VGG-16 partial
(run with no gradient; on the card its block 1 launches the ``vgg_block1``
kernel once a step): the detector in train mode (BatchNorms on batch
statistics, the tail's dropout), the mean sigmoid cross-entropy over every
frame and class, Adam, the elementwise accuracy, a checkpoint in the JAX
package's format and, with ``--export_pt``, an ``obj_detect.pt`` with the
reference's keys.

    python -m videonavqa_tpu_torch.cli.train_obj_detector --data frames.npz \\
        --checkpoint_path det.npz --export_pt obj_detect.pt

``--data``: an .npz with ``images`` (uint8 [N, 160, 208, 3], BGR) and
``targets`` ([N, classes], 0/1). Each epoch visits the frames in the order
``np.random.RandomState(epoch).permutation(N)``, dropping the last partial
batch, and prints its mean loss and accuracy. ``--synthetic N`` (frames
rendered from synthetic houses) needs the datagen renderer, which is not
ported yet (ROADMAP: the JAX-free tools): it exits. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from videonavqa_tpu_torch.stem import (
    init_obj_detector, init_vgg_partial, obj_detector, vgg_partial,
    vgg_partial_block1_kernel,
)
from videonavqa_tpu_torch.train.step import make_optimizer
from videonavqa_tpu_torch.utils import checkpoint as ckpt
from videonavqa_tpu_torch.utils.device import resolve_device, tree_to


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, help=".npz with 'images' u8 and 'targets'")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="refused: rendering labeled frames is not ported yet "
                             "(ROADMAP: the JAX-free tools)")
    parser.add_argument("--num_filters", type=int, default=512)
    parser.add_argument("--tail_hidden_dim", type=int, default=1024)
    parser.add_argument("--tail_dropout_p", type=float, default=0.5)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--l_rate", type=float, default=1e-4)
    parser.add_argument("--num_epochs", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint_path", type=str)
    parser.add_argument("--export_pt", type=str,
                        help="also export a reference-compatible obj_detect.pt")
    parser.add_argument("--frcnn_pretrained_path", type=str)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the default) or 'cpu'")
    return parser


def sigmoid_bce(logits, targets):
    """Elementwise ``-y log s(x) - (1 - y) log s(-x)``, as optax's."""
    return -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)


def make_train_step(vgg_params, params, optimizer, *, tail_dropout_p, generator, use_kernel):
    """step(state, images u8 [B, 160, 208, 3], targets [B, classes]) ->
    (new_state, loss, accuracy): the frozen VGG with no gradient, the
    detector in train mode, one Adam step on ``params`` in place. The convs
    run in the functions' default dtype, bf16, as the JAX trainer's."""
    vgg = vgg_partial_block1_kernel if use_kernel else vgg_partial

    def step(state, images_u8, targets):
        with torch.no_grad():
            feats = vgg(vgg_params, images_u8.float() / 255.0)
        logits, new_state = obj_detector(params, state, feats, train=True, logits=True,
                                         generator=generator, tail_dropout_p=tail_dropout_p)
        loss = torch.mean(sigmoid_bce(logits, targets))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        acc = torch.mean(((logits.detach() > 0) == (targets > 0.5)).float())
        return new_state, loss.detach(), acc

    return step


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.synthetic:
        raise SystemExit("--synthetic: rendering labeled frames from synthetic houses is not "
                         "ported yet (ROADMAP: the JAX-free tools); pass --data <npz>")
    if not args.data:
        raise SystemExit("need --data or --synthetic N")
    device = resolve_device(args.device)
    with np.load(args.data) as z:
        images, targets = z["images"], z["targets"].astype(np.float32)
    nb_classes = targets.shape[1]
    print(f"{images.shape[0]} frames, {nb_classes} classes, "
          f"{targets.mean():.3f} positive rate")

    gen = torch.Generator().manual_seed(args.seed)
    if args.frcnn_pretrained_path and os.path.exists(args.frcnn_pretrained_path):
        from videonavqa_tpu_torch.utils import torch_import as ti

        vgg_params = ti.import_vgg_partial(
            ti.load_torch_state_dict(args.frcnn_pretrained_path, key=None))
    else:
        vgg_params = init_vgg_partial(gen)
    params, state = init_obj_detector(gen, nb_classes=nb_classes, num_filters=args.num_filters,
                                      tail_hidden_dim=args.tail_hidden_dim)
    vgg_params, params, state = (tree_to(t, device) for t in (vgg_params, params, state))
    optimizer = make_optimizer(params, args.l_rate)
    step = make_train_step(
        vgg_params, params, optimizer, tail_dropout_p=args.tail_dropout_p,
        generator=torch.Generator(device=device).manual_seed(args.seed + 1),
        use_kernel=device.type == "cuda")

    n, B = images.shape[0], args.batch_size
    for epoch in range(args.num_epochs):
        order = np.random.RandomState(epoch).permutation(n)
        losses, accs = [], []
        for s in range(0, n - B + 1, B):
            idx = order[s:s + B]
            x = torch.from_numpy(images[idx]).to(device)
            y = torch.from_numpy(targets[idx]).to(device)
            state, loss, acc = step(state, x, y)
            losses.append(float(loss))
            accs.append(float(acc))
        print(f"Epoch {epoch}: loss {np.mean(losses):.4f} "
              f"elementwise-acc {np.mean(accs):.4f}")

    if args.checkpoint_path:
        ckpt.save_checkpoint(args.checkpoint_path, params=params, state=state,
                             meta={"model": "obj_detector", "nb_classes": nb_classes})
    if args.export_pt:
        from videonavqa_tpu_torch.utils.torch_import import export_obj_detector_pt

        export_obj_detector_pt(params, state, args.export_pt)
        print("exported", args.export_pt)
    return params, state


if __name__ == "__main__":
    main()
