"""Telemetry spine (the part the serving metrics use)."""
