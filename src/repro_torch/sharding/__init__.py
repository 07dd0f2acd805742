"""Logical-axis sharding rules of the port (mirror of ``repro/sharding``)."""
