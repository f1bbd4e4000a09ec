"""K2, the dense edge chain's forward in train mode, as a share of its roofline, percent
(``work.chain_fwd``)."""

KERNELS = ["edge_aggregate_kernel<false, float>"]
FAMILY = "edge_fwd"


def read(r):
    return r.roofline(FAMILY, KERNELS)
