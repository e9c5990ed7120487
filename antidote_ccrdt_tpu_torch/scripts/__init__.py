"""Runnable workers of the port (``python -m antidote_ccrdt_tpu_torch.scripts.<name>``)."""
