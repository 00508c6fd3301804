"""Tensor ops: grid sampling, the depth-guided sampler, compositing and
its CUDA kernel."""
