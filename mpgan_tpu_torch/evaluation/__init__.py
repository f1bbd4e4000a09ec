"""Evaluation metrics (``mpgan_tpu/evaluation``): W1 of particle features and jet mass."""
