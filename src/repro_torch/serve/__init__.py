"""Serving engines (port of ``repro/serve``)."""
