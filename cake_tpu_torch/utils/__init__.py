"""Host-side utilities of the port (``metrics``: registry and flight recorder)."""
