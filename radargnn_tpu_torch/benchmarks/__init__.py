"""The port's kernel entry points on the card: `kernel_check` (the four
kernel checks of the JAX package's benchmarks/pallas_check.py, plus the v1
pair) and `kernel_bench` (the fused message segment-max against the library
path at flagship scale, the port of benchmarks/pallas_bench.py)."""
