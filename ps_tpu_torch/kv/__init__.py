"""Key-value push/pull layer — the heart of the parameter-server API."""
