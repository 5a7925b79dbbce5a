"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``sw_step``: the shallow-water step; ``flash``: the
flash-attention forward)."""
