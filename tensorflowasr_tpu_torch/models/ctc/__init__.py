"""CTC models of the port."""
