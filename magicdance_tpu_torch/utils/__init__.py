"""Utilities: metric logging, image grids and device timing."""
