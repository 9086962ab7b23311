"""device_idle_pct.flips: the share of the traced window in which no
operation ran on the device, 100 (1 - union of the device's operation
intervals / window), in the cells that report flips_per_s."""


def read(ctx):
    return ctx["trace"].idle_pct()
