"""Graph operators, the Lanczos recursion and its CUDA kernel."""
