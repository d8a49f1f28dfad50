"""controllers/node of the PyTorch port (see the package docstring)."""
