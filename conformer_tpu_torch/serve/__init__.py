"""Serving: model runner and REST server."""
