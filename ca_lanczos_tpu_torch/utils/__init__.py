"""Test fixtures and carry-across helpers."""
