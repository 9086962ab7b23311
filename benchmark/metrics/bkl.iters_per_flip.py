"""bkl.iters_per_flip: virtual iterations over applied flips (the change
of MCState.accepted) in the window: N / z, whether a change of iters_per_s
came from speed or from the state."""


def read(ctx):
    w = ctx["work"]
    if not w.get("applied_flips"):
        return None
    return w["iters"] / w["applied_flips"]
