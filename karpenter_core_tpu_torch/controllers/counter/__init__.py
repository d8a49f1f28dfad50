"""controllers/counter of the PyTorch port."""
