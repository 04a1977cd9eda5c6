"""fleet_tokens_per_s: ``tokens_per_s`` of a fleet cell, whose functions
cold-start inside the window: every cold start's cost is in it.  Its
own name, so it carries its own bound: the pool's eviction makes a
fleet's runs spread far wider than a single warm function's."""

from portbench.metrics.tokens_per_s import read  # noqa: F401

SOURCE = "host_clock"
