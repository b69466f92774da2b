"""Measurement scripts of the port; each runs on a machine with the card."""
