"""Serving entry points of the port (counterpart: ``repro/launch``)."""
