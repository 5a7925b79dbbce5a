"""Benchmarks of the PyTorch port that run under its launcher."""
