"""Denoising front end (host numpy; demucs through its command line)."""
