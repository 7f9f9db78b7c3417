"""Launchers (mirrors ``repro.launch``): ``serve`` and ``train``."""
