"""Entry points of the port (mirror of ``repro/launch``)."""
