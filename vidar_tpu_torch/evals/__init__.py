"""Eval entry points of the port."""
