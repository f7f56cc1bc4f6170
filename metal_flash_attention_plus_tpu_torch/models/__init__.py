"""Models: the flagship transformer, its cached serving twin and the
parameter converter from the JAX package."""
