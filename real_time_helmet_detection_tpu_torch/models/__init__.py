"""The detector network, ported from the JAX package."""
