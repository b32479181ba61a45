"""Command-line tools of the port (``python -m ria_tpu_torch.tools.<name>``)."""
