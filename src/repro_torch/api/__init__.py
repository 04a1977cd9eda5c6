"""Artifact loading the serving layer uses (the port's own copy of the
report loading behind ``repro.api.artifacts.as_report``)."""
