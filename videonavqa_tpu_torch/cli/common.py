"""What the training harness shares across models (the counterpart of the JAX
package's cli/common.py): each model's train-step options and learning rate
as its preset runs it, and MAC's learning-rate schedule, which the harness
applies with ``train/step.py set_learning_rate`` at each epoch."""

from __future__ import annotations

# make_train_step's options for each model the port trains, as the harness
# sets them (cli/common.py Harness) at the preset's --loss_reduction: every
# q_and_v model and the video-only harness clip the global norm at 1.0, and
# MAC clamps each gradient element to +-1 first; the question-only harness
# clips nothing. eval.sh's presets sum the loss; the others run at their
# parser's default, the mean. The question-only harness also turns class
# weights on by default (--use_class_weights); they come from the training
# set's label counts, so the caller passes them, not these options.
TRAIN_STEP_OPTIONS = {
    "film_attn_pt": dict(reduction="sum", clip_value=1.0),
    "time_multi_hop": dict(reduction="sum", clip_value=1.0),
    "mac": dict(reduction="mean", clip_value=1.0, elementwise_clamp=1.0),
    "v_only_cnn2d_lstm": dict(reduction="mean", clip_value=1.0),
    "concat2d": dict(reduction="mean", clip_value=1.0),
    "lstm": dict(reduction="mean"),
}
# The presets' learning rates (eval.sh; the others: their parser's default,
# build_q_and_v_parser's for MAC and concat2d, v_only_eval's and q_only_eval's).
PRESET_L_RATE = {"film_attn_pt": 1e-4, "time_multi_hop": 5e-5, "mac": 1e-4,
                 "v_only_cnn2d_lstm": 1e-4, "concat2d": 1e-4, "lstm": 1e-5}


def mac_lr_for_epoch(l_rate: float, epoch: int) -> float:
    """The reference MAC schedule: its "warmup" lr/10 is assigned after epoch
    0 has trained, so epoch 0 trains at the full lr, epoch 1 at lr/10, and
    every later epoch at the full lr again."""
    return l_rate / 10.0 if epoch == 1 else l_rate
