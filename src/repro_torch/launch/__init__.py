"""Launchers (mirrors ``repro.launch``): ``serve``."""
