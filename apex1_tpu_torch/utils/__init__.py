"""Tracing and metrics helpers."""
