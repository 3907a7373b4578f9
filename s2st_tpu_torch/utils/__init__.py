"""Diagnostics of the port's training runs."""
