"""controllers/inflightchecks of the PyTorch port."""
