"""Models: DenseNet3 and its BatchNorm / activations."""
