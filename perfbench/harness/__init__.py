"""The benchmark's harness: spec discovery, traffic generation, the drivers
of the serving and training windows, trace reduction and the comparison
that decides ``correct``.  Nothing here imports JAX or the JAX package."""
