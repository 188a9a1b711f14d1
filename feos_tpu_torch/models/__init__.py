"""PC-SAFT models."""
