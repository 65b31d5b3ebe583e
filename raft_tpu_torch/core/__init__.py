"""Execution context and the v2 container format."""
