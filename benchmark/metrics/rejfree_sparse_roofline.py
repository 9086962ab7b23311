"""rejfree_sparse_roofline: the rejfree_sparse kernel's share of its roofline in the traced
window (roofline.py; its work floor in work/rejfree_sparse.py)."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx, "rejfree_sparse")
