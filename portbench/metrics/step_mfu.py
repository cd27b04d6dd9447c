"""``step_mfu``: the training step's model FLOPs over the seconds of the
traced run's untraced window (the one a ``--trace 0`` run measures), as a
share of the card's bf16 peak (``flops.step_model_flops``: recompute not
counted). Moves ``train_tokens_per_s``."""

from portbench import flops


def read(run):
    if run.device.type != "cuda" or run.window.steps == 0:
        return None
    per_step = flops.step_model_flops(run.config, run.mix["batch"], run.mix["seq_len"])["total"]
    return flops.mfu_pct(per_step * run.window.steps, run.window.seconds)
