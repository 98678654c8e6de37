"""Checkpoints of the train state, in the JAX package's on-disk layout."""
