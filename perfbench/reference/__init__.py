"""The plain reference the benchmark holds the port to.

Plain PyTorch and NumPy in float64.  It imports nothing of the port
(`sgdnet_tpu_torch`) nor of the JAX package, and takes nothing the port
built: from the generated design it makes its own column split, head
rounding, row padding, standardization, lambda sequence and step sizes.
"""
