"""Drivers: the per-hole pipeline."""
