"""Utilities: image grids and PNG output."""
