"""K5, the knn layer's search and edge chain in one kernel, in the training step, as a
share of its roofline, percent (``work.chain_fwd`` with the search)."""

KERNELS = ["knn_fwd_kernel<true, float>"]
FAMILY = "knn_fwd"


def read(r):
    return r.roofline(FAMILY, KERNELS)
