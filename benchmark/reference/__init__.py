"""The benchmark's plain reference: float32 (TF32 off) PyTorch, float64
preprocessing with scipy's filter designs.  It imports nothing of the
program and takes only the benchmark's own inputs and weights."""
