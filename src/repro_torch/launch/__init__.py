"""Launchers (port of ``repro.launch``): ``train``."""
