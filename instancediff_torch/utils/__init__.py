"""Parameter conversion from the JAX package's trees."""
