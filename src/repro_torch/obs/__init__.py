"""Observability pieces the serving layer uses (the port's own copies of
``repro.obs.tracing`` and ``repro.obs.metrics``, trimmed to what
``EnginePool`` needs)."""
