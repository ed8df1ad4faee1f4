"""A frozen copy of the port's plain PyTorch paths (no kernel of the port), the reference the benchmark holds the port against."""
