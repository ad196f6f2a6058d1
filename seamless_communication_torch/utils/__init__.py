"""Tracing and profiling helpers."""
