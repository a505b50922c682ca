"""Command-line entry points of the port (``python -m tmae_tpu_torch.tools.<name>``)."""
