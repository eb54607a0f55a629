"""Command-line entry points of the port (``python -m paradis_torch.cli.<name>``)."""
