"""Configurations of the port (``repro/configs`` counterpart)."""
