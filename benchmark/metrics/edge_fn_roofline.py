"""K4, the dense edge chain with the node MLP fused (eval), as a share of its roofline,
percent (``work.fn_fwd``)."""

KERNELS = ["edge_aggregate_kernel<true, float>"]
FAMILY = "edge_fn"


def read(r):
    return r.roofline(FAMILY, KERNELS)
