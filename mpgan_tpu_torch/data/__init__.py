"""Data layers (numpy): JetNet jets and sparsified-MNIST clouds."""
