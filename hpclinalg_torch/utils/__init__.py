"""Conversions from the JAX package's container state."""
