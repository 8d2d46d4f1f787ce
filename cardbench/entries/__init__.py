"""Timed entries of the port, one module each, found by the name a traffic
file gives."""
