"""K6, the knn edge chain's backward, as a share of its roofline, percent
(``work.chain_bwd`` over the k neighbours, no recompute; the kernel and the helpers it
launches)."""

KERNELS = ["knn_edge_bwd_kernel<float>", "pack_weights", "reduce_sender_slabs<float>",
           "reduce_wgrads"]
FAMILY = "knn_bwd"


def read(r):
    return r.roofline(FAMILY, KERNELS)
