"""Core utilities of the port (canonical serialization)."""
