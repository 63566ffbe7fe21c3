"""Query models of the PyTorch port."""
