"""Launchers (PyTorch port of ``repro.launch``): the Level-B serving
launcher ``serve``, the training driver ``train``, the production mesh
``mesh`` and the meta-device ``dryrun``."""
