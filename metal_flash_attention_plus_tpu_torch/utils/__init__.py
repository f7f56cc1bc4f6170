"""Measurement helpers for the port (run on the card)."""
