"""Synthetic rating data."""
