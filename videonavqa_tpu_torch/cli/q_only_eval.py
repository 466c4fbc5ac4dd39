"""Train and validate a question-only model (the port of the JAX package's
cli/q_only_eval.py): ``--model lstm`` or ``bow``.

It validates every ``--stats_after_every`` epochs and keeps the checkpoint of
the best validation accuracy (micro F1), the first validation always. Its
loop runs on the mesh the flags ask for (``cli/common.py on_mesh``), the
params placed on it before the first batch (``Harness.shard_model``).
"""

import argparse

from videonavqa_tpu_torch.cli.common import Harness, whole_params, add_common_args, on_mesh
from videonavqa_tpu_torch.data import BatchLoader
from videonavqa_tpu_torch.train.step import make_optimizer
from videonavqa_tpu_torch.utils import checkpoint as ckpt


def build_parser():
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--embed_size", type=int, default=128)
    parser.add_argument("--hidden_size", type=int, default=128)
    parser.add_argument("--model", type=str, choices=["lstm", "bow"])
    parser.add_argument("--batch_size", type=int, default=1024)
    parser.add_argument("--l_rate", type=float, default=1e-5)
    parser.add_argument("--num_epochs", type=int, default=1000)
    parser.add_argument("--stats_after_every", type=int, default=50)
    parser.add_argument("--use_class_weights", type=lambda s: s.lower() == "true",
                        default=True)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.model:
        raise SystemExit("--model is required")
    return on_mesh(_main, args)


def _main(args):
    h = Harness(args, args.model, q_only=True)
    train_ds = h.dataset("train")
    val_ds = h.dataset("val", deterministic=True)
    print("%d train examples, %d validation examples" % (len(train_ds), len(val_ds)))
    if args.use_class_weights:
        h.class_weights = train_ds.get_class_weights(h.cfg.num_classes)
        print("Using class weights", h.class_weights)

    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                               num_workers=args.num_workers, seed=args.seed)
    val_loader = BatchLoader(val_ds, args.batch_size, shuffle=False, mode="val",
                             num_workers=args.num_workers, seed=args.seed)

    params, state = h.init_model()
    params, state, optimizer = h.shard_model(params, state,
                                             make_optimizer(params, args.l_rate))
    # the question-only harness clips no gradient
    train_step, eval_step = h.make_steps(optimizer, reduction="mean")

    best_acc = -1.0  # the first validation always checkpoints
    for epoch in range(args.num_epochs):
        state, summary = h.run_epoch(train_step, params, state, train_loader, epoch,
                                     train=True)
        if (epoch + 1) % args.stats_after_every == 0:
            print("Train Epoch: {}\tAverage loss: {:.6f}\tF1: w{:.4f}, micro{:.4f}".format(
                epoch + 1, summary["loss"], summary["f1_w"], summary["f1_micro"]))
            _, vs = h.run_epoch(eval_step, params, state, val_loader, epoch, train=False)
            print("Validation:\tAverage loss: {:.6f}, F1: w{:.4f}, micro{:.4f}".format(
                vs["loss"], vs["f1_w"], vs["f1_micro"]))
            if vs["f1_micro"] > best_acc and args.checkpoint_path:
                best_acc = vs["f1_micro"]   # global: the same on every rank
                ckpt.save_checkpoint(
                    args.checkpoint_path, params=params, state=state, optimizer=optimizer,
                    meta={"epoch": epoch, "model": args.model, "val_acc": best_acc})
    h.metrics.close()
    return whole_params(h, params), state


if __name__ == "__main__":
    main()
