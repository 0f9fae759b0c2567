"""Telemetry, the background artifact writer and math utilities."""
