"""Core HGNN stages, plans and the stage-graph executor (port of
``repro/core``).  Import the submodules directly; this package imports
nothing so that the numpy-only host modules stay light."""
