"""Generation's share of the FP32 peak, percent: every product the completed batches need
(``work.gen_batch``) over the window's wall time, over 67 TFLOP/s."""


def read(r):
    return r.mfu()
