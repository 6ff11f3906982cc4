"""Helpers shared by the port's apps."""
