"""Hand-written device kernels (Pallas through Triton for the GPU)."""
