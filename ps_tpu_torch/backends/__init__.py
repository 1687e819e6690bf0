"""Backend engines: 'cuda' (one device; the counterpart of 'tpu')."""
