"""Exact long-form windows (single device); the mesh paths are not ported yet."""
