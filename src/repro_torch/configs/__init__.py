"""The port's own copies of the paper's task constants."""
