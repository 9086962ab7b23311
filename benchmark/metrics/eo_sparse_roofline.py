"""eo_sparse_roofline: the eo_sparse kernel's share of its roofline in the traced
window (roofline.py; its work floor in work/eo_sparse.py)."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx, "eo_sparse")
