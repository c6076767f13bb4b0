"""Twins of the reference codec modules that reach its device programs."""
