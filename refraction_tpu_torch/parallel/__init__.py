"""Multi-device rendering over a list of local torch devices (one process)."""
