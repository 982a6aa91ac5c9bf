"""Launchers of the port (mirrors ``repro.launch``)."""
