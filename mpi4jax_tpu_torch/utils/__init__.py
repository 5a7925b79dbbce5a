"""Validation and runtime helpers of the PyTorch port."""
