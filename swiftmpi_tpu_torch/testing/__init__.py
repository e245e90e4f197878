"""Test support of the port: deterministic fault injection."""
