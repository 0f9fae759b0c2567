"""Simulated fixtures (numpy; copied from vampomi_tpu.sim)."""
