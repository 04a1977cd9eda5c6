"""Launchers (PyTorch port of ``repro.launch``): the Level-B serving
launcher ``serve`` and the training driver ``train``."""
