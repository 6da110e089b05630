"""FACT model: layers, blocks and decoding (PyTorch)."""
