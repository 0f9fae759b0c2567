"""Telemetry and the background artifact writer."""
