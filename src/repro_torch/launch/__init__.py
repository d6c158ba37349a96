"""Launchers of the port: the serve entry point."""
