"""Twins of the reference rate-control modules that reach its device programs."""
