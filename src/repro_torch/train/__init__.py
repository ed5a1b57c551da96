"""Training loop."""
