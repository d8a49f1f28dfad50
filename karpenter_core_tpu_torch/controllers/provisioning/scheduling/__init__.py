"""controllers/provisioning/scheduling of the PyTorch port (see the package docstring)."""
