"""Training on one card."""
