"""Host-side loaders and datasets."""
