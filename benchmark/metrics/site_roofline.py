"""site_roofline: the site kernel's share of its roofline in the traced
window (roofline.py; its work floor in work/site.py)."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx, "site")
