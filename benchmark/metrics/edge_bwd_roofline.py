"""K3, the dense edge chain's backward, as a share of its roofline, percent: the least time
of the steps' needed backward work (``work.chain_bwd``: da and dW, no recompute) over
the traced time of the kernels below (the backward and the helpers it launches)."""

KERNELS = ["edge_aggregate_bwd_kernel<float>", "pack_weights", "reduce_sender_slabs<float>",
           "reduce_wgrads"]
FAMILY = "edge_bwd"


def read(r):
    return r.roofline(FAMILY, KERNELS)
