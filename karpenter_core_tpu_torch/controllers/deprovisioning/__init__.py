"""controllers/deprovisioning of the PyTorch port (see the package docstring)."""
