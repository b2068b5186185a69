"""Timing and failure-detection utilities."""
