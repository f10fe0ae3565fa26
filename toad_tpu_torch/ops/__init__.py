"""Ported ops: masked pooling, the fused pool and its CUDA kernel."""
