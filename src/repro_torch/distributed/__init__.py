"""Distributed pieces of the port that make sense on one device (port of
part of ``repro/distributed``)."""
