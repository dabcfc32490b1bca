"""Serving helpers."""
