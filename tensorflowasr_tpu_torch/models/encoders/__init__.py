"""Encoders of the port."""
