"""The multitask training losses (NHWC inputs, as the JAX package's)."""
