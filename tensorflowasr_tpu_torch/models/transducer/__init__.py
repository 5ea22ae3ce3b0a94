"""Transducer models of the port."""
