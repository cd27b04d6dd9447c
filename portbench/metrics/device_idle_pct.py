"""``device_idle_pct``: the share of the traced window in which no kernel,
copy or memset ran on the card (the union of their intervals in the
``torch.profiler`` trace). Moves ``train_tokens_per_s``."""


def read(run):
    tv = run.trace
    if tv is None or tv.window_s <= 0 or tv.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tv.busy_s / tv.window_s)
