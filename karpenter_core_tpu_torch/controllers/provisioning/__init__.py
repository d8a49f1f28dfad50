"""controllers/provisioning of the PyTorch port (see the package docstring)."""
