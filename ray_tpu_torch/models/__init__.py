"""Model geometries and parameter trees of the PyTorch port."""
