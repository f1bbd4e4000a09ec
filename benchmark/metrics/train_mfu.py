"""The D+G step's share of the FP32 peak, percent: every product the completed steps need
(``work.train_step``, no recompute) over the window's wall time, over 67 TFLOP/s."""


def read(r):
    return r.mfu()
