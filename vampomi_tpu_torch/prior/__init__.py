"""Mixture prior: denoisers and EM updates."""
