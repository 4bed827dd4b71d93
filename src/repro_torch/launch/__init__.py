"""Launchers of the port: serving."""
