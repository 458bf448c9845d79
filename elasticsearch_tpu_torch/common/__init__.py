"""Shared pieces of the port: the error classes (a copy of the reference's)."""
