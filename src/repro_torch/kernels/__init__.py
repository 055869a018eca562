"""The forest-scoring kernels (CUDA + plain PyTorch), their build and dispatch."""
