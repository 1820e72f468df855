"""Ops: numeric helpers, distributions, spatial transformer and its kernel."""
