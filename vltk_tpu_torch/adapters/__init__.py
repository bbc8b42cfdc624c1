"""Adapters of the port: the FRCNN feature-extraction step."""
