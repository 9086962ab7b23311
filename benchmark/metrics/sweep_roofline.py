"""sweep_roofline: the sweep kernel's share of its roofline in the traced
window (roofline.py; its work floor in work/sweep.py)."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx, "sweep")
