"""rejfree_sat_roofline: the rejfree_sat kernel's share of its roofline in
the traced window (roofline.py; its work floor in work/rejfree_sat.py)."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx, "rejfree_sat")
