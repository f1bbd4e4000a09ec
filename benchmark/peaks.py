"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
limit): the rates every share of a peak or of a roofline is taken against."""

PEAK_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores
PEAK_HBM = 3.35e12  # bytes/s, HBM3
