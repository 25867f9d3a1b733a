"""Command-line launchers (port of ``repro/launch``)."""
