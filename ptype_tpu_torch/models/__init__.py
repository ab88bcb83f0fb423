"""Models of the port: the transformer, its weights, and generation."""
