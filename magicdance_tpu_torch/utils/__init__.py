"""Utilities: metric logging and image grids."""
