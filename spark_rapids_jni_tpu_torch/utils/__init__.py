"""Host and device helpers of the PyTorch port."""
