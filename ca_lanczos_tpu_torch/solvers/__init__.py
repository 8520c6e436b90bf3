"""Lanczos drivers and the f64 polish."""
