"""Atomic, keep-k checkpoints in the JAX package's on-disk layout."""
