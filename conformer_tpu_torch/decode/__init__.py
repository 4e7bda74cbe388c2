"""Decoding."""
