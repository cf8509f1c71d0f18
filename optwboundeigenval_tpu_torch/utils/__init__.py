"""Parameter-dict helpers, weight interop and the CUDA build."""
