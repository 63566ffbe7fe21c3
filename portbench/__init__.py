"""The PyTorch/CUDA port's benchmark: see ``portbench/README.md``."""
