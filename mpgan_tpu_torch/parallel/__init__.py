"""Data parallelism over ``torch.distributed`` (``mpgan_tpu/parallel``)."""
