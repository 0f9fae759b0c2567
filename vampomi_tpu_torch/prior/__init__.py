"""Mixture prior: denoisers and EM updates; marginal-effect prior estimators."""
