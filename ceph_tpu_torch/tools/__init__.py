"""Command-line tools of the PyTorch port (timing probes run on the card)."""
